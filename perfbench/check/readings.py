"""Readings for the limits of `correct` and for the serving rate, on the card:
the cell's driver run on several seeds in one process, one JSON line a
run (its end-to-end metrics, the numbers compared, and with `--controls`
the control's and the planted faults' readings among its notes).

    python3 perfbench/check/readings.py --workload mistral7b.synth \\
        --seeds 11,12,13 --seconds 20 [--controls] [--set batch=128]

`--set key=value` overrides a traffic parameter (a JSON value) for every
run, as a rate sweep needs; the benchmark's own runs never do.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:] = [p for p in sys.path if not os.path.abspath(p or ".").startswith(
    os.path.join(ROOT, "perfbench"))]
sys.path.insert(0, ROOT)


def main() -> int:
    from perfbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()
    why_not = harness.cards(1)
    if why_not:
        print(why_not, file=sys.stderr)
        return 2
    import importlib

    for seed in [int(x) for x in args.seeds.split(",")]:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                trace=0)
        spec, w, run = harness.prepare(ns, time.perf_counter())
        for kv in args.set:
            k, v = kv.split("=", 1)
            run.traffic[k] = json.loads(v)
        run.traffic["controls"] = args.controls
        driver = importlib.import_module(f"perfbench.drivers.{run.traffic['driver']}")
        with contextlib.redirect_stdout(sys.stderr):
            out = driver.run(run)
        print(json.dumps({"seed": seed, "set": args.set, "e2e": out.end_to_end,
                          "setup": out.setup_split, "checks": out.checks,
                          "attempted": out.attempted, "failed": out.failed,
                          "memory_peak_bytes": out.memory_peak_bytes, "notes": out.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
