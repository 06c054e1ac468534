"""The harness: finds the cell, its configuration, traffic, limits and
metric readers by name, refuses to run without the cards the cell asks
for, runs the traffic's driver, guards the loaded modules, and prints the
result line."""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import sys
from typing import Dict, List, Optional

from . import modelcfg
from .common import HERE, benchmark_spec, forbidden_loaded, load_json, result_line
from .drivers import Run


def reader_path(name: str):
    """The reader of metric `name`: perfbench/metrics/<name>.py, else the
    reader shared by the cells, perfbench/metrics/<name up to its first
    dot>.py (`idle_share.train` reads with idle_share.py)."""
    whole = HERE / "metrics" / f"{name}.py"
    return whole if whole.exists() else HERE / "metrics" / f"{name.split('.', 1)[0]}.py"


def load_reader(name: str):
    """The reader of metric `name` as a module with `read(context)`, which
    gives a number, or None where it finds nothing to read. What the metric
    is (unit, layer, what it moves, source) is BENCHMARK.json's."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics this cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def per_layer_values(spec: dict, cell: str, context: dict) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(spec, cell, "per_layer"):
        value = load_reader(m["name"]).read(context)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cards(chips: int) -> Optional[str]:
    """None when `chips` CUDA cards are here, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: this benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} here"
    return None


def prepare(args: argparse.Namespace, t_start: float, device: str = "cuda") -> tuple:
    """(spec, workload entry, Run) for the arguments."""
    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
    w = cells[args.workload]
    run = Run(cell=w["name"], cfg=modelcfg.load(w["config"]),
              traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
              limits=load_json(HERE / "limits" / f"{w['name']}.json")["limits"],
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
              t_start=t_start)
    return spec, w, run


def report(spec: dict, w: dict, run: Run, outcome, device: dict) -> str:
    """Earlier lines to standard error, and the result line."""
    err = sys.stderr
    split = outcome.setup_split
    setup_s = sum(split.values())
    print("setup_s " + f"{setup_s:.4f} = " + " + ".join(
        f"{k} {v:.4f}" for k, v in split.items()), file=err)
    for line in outcome.notes:
        print(line, file=err)
    if run.trace:
        metrics = per_layer_values(spec, w["name"], outcome.context)
        trace = outcome.context.get("trace")
        breakdown = None
        if trace is not None:
            device = dict(device, busy_s=trace.busy_s, window_s=trace.window_s)
            breakdown = trace.breakdown()
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(spec, w["name"], "end_to_end")}
        breakdown = None
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    return result_line(outcome.correct, outcome.attempted, outcome.failed, metrics, device,
                       breakdown, outcome.checks)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    spec, w, run = prepare(args, t_start)
    why_not = cards(w["chips"])
    if why_not:
        print(f"perfbench: {why_not}", file=sys.stderr)
        return 2
    import torch

    driver = importlib.import_module(f"perfbench.drivers.{run.traffic['driver']}")
    with contextlib.redirect_stdout(sys.stderr):  # the program's own prints
        outcome = driver.run(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"], "memory_peak_bytes": outcome.memory_peak_bytes}
    line = report(spec, w, run, outcome, device)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(line, flush=True)
    return 0
