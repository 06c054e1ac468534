"""What the program's tracer costs when it is on, in one process:

    python3 perfbench/trace_cost.py [--seed N] [--calls 4] [--updates 40] [--device cuda]

`spans`: the host time of one span opened and closed, on and off (the
mean of 200000). `synth`: whole `synthesize_batch` calls of the
mistral7b.synth cell (its configuration, weights and traffic), the tracer
off and on in turns (off, on, on, off, ...), each call timed on the host
clock and ended by the host copy of its audio. `train`: `Trainer.fit` on
the smollm2.train cell's rows, the tracer off and on in blocks of 5
updates (off, on, on, off, ...), each block timed from a synchronized
card to a synchronized card. Prints one JSON line each; nothing here is
part of a cell's run.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import modelcfg  # noqa: E402
from perfbench import served as served_mod  # noqa: E402
from perfbench.common import HERE, load_json, sub_seed  # noqa: E402
from perfbench.drivers import Clock, Run  # noqa: E402


def _run(cell: str, config: str, traffic: str, seed: int, device: str) -> Run:
    return Run(cell=cell, cfg=modelcfg.load(config),
               traffic=load_json(HERE / "traffic" / f"{traffic}.json"),
               limits=load_json(HERE / "limits" / f"{cell}.json")["limits"], seed=seed,
               seconds=0.0, trace=False, device=device)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def span_cost(n: int = 200_000) -> dict:
    from kalle_tpu_torch.utils import trace

    out = {}
    for state in ("off", "on"):
        trace.reset()
        (trace.enable if state == "on" else trace.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost"):
                pass
        out[f"span_{state}_ns"] = (time.perf_counter_ns() - t0) / n
    trace.disable()
    trace.reset()
    return out


def synth_cost(seed: int, calls: int, device: str) -> dict:
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.infer.pipeline import InferTools
    from kalle_tpu_torch.utils import trace
    from perfbench.drivers.synth import call_texts

    run = _run("mistral7b.synth", "mistral7b-sigma", "synth-b256", seed, device)
    tr, s = run.traffic, modelcfg.sizes(run.cfg)
    lcfg, params, codec = served_mod.program_model(run, Clock(), s)
    tmp = tempfile.mkdtemp(prefix="perfbench-cost-")
    try:
        tools = InferTools(lcfg, params, ByteTokenizer(base_vocab=s["base_vocab"]), codec,
                           output_root=tmp, timestamp=False, seed=sub_seed(seed, 43))
        walls = {"off": [], "on": []}
        order = ["off", "on", "on", "off"] * ((calls + 3) // 4)
        for c, state in enumerate(["off"] + order[:calls]):  # the first warms up
            (trace.enable if state == "on" else trace.disable)()
            trace.reset()
            t0 = time.perf_counter()
            tools.synthesize_batch(call_texts(tr, seed, c), max_frames=tr["max_frames"],
                                   batch_size=tr["batch"],
                                   prompt_buckets=tuple(tr["prompt_buckets"]))
            dt = time.perf_counter() - t0
            if state == "on":
                n_spans = len(trace.snapshot()["spans"])
            trace.disable()
            if c:
                walls[state].append(dt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"what": "synth call", "calls_off_s": walls["off"], "calls_on_s": walls["on"],
            "spans_a_call": n_spans, "steps_a_call": tr["max_frames"],
            "on_minus_off_share": statistics.median(walls["on"]) / statistics.median(walls["off"])
            - 1.0}


class _Done(Exception):
    pass


def train_cost(seed: int, updates: int, device: str) -> dict:
    from kalle_tpu_torch.core.config import DataConfig, ExperimentConfig, TrainConfig
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.train import trainer as trainer_mod
    from kalle_tpu_torch.utils import trace
    from perfbench.drivers.train import latents, make_rows, write_dataset

    run = _run("smollm2.train", "smollm2-1.7b-sigma", "train-dyn11k", seed, device)
    tr, cfg = run.traffic, run.cfg
    s = modelcfg.sizes(cfg)
    tmp = tempfile.mkdtemp(prefix="perfbench-cost-")
    block, warm = 5, 6
    order = ["off", "on", "on", "off"] * ((updates // block + 3) // 4)
    states = ["off"] * warm + [st for st in order[:updates // block] for _ in range(block)]
    times = {"off": [], "on": []}
    mark = {"t": None}
    real_step = trainer_mod.train_step

    def step_fn(tstate, *a, **k):
        m = real_step(tstate, *a, **k)
        i = tstate.step
        if i >= warm and (i - warm) % block == 0:  # a block ends at update i
            _sync(device)
            now = time.perf_counter()
            if mark["t"] is not None:
                times[states[i - 1]].append((now - mark["t"]) / block)
            mark["t"] = now
        if i == len(states):
            raise _Done  # no checkpoint at the end
        (trace.enable if states[i] == "on" else trace.disable)()
        return m

    try:
        rows = make_rows(tr, seed)
        meta = write_dataset(tmp, rows, latents(rows, seed, s["latent"]))
        exp = ExperimentConfig(
            project_name="perfbench", exp_dir=os.path.join(tmp, "exp"),
            model=modelcfg.llasa_config(cfg, "train"),
            train=TrainConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                              warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                              gradient_accumulation_steps=tr["grad_accum"],
                              audio_loss_weight=tr["audio_loss_weight"],
                              end_loss_weight=tr["end_loss_weight"],
                              log_interval=tr["log_interval"], save_interval=10 ** 12,
                              seed=sub_seed(seed, 35)),
            data=DataConfig(meta_path=meta, latent_kind="sigma",
                            max_token_length=tr["max_token_length"],
                            batch_size=tr["batch_size"], use_dynamic=True,
                            num_workers=tr["num_workers"], prefetch_size=tr["prefetch"],
                            length_buckets=tuple(tr["length_buckets"])))
        trainer = trainer_mod.Trainer(exp, ByteTokenizer(base_vocab=s["base_vocab"]),
                                      device=device)
        trainer_mod.train_step = step_fn
        try:
            trainer.fit()
        except _Done:
            pass
        finally:
            trainer_mod.train_step = real_step
            trace.disable()
        n_spans = len(trace.snapshot()["spans"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"what": "train update", "blocks_off_s": times["off"], "blocks_on_s": times["on"],
            "spans_recorded": n_spans,
            "on_minus_off_share": statistics.median(times["on"]) / statistics.median(times["off"])
            - 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=5600000001)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--what", default="spans,synth,train")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from kalle_tpu_torch.ops.kernels import _build

        _build.build()
        print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for what in args.what.split(","):
        if what == "spans":
            out = span_cost()
        elif what == "synth":
            out = synth_cost(args.seed, args.calls, args.device)
        else:
            out = train_cost(args.seed, args.updates, args.device)
        print(json.dumps(out), flush=True)
        served_mod.free(torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
