"""A/B of the port's host-bound decode paths in two checkouts, on one card.

    python3 ab_decode.py [--after-training] PARENT_DIR CHANGE_DIR

Runs each checkout in a process of its own, in the order parent, change,
change, parent, so that a drift of the card or the host over the call
weighs on both alike. Each process builds chip_smoke.py's full-width int8
model from seed 0 and times, with the clock of the host around a
synchronized card:

  * `generate` at batch 32, 32 text ids, 128 frames: four runs, the first
    (kernel builds, allocator warm-up) dropped;
  * `ContinuousBatcher.run` of 64 requests (chip_smoke's serving texts) at
    batch 32 and at batch 8, 128 frames: two runs each.

With --after-training each process takes these readings (keys
`before_training_...`), then runs chip_smoke.py's phase 4 (`Trainer.fit`
of the full-width model, 10 steps, as chip_smoke.py does before it
serves), then takes them again.

Prints one JSON line of ms a decode step for each process, then the card's
name and power limit, then a JSON line with each checkout's readings
pooled. Compare the two checkouts only within one call. Needs a CUDA card.
"""
import json
import os
import statistics
import subprocess
import sys
import time


def measure(tree: str, after_training: bool = False) -> dict:
    """The readings of one checkout (this process imports its code)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not after_training:
        return decode_readings(cs)
    import tempfile

    out = {f"before_training_{k}": v for k, v in decode_readings(cs).items()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        cs.phase_train("", root)
    torch.cuda.empty_cache()
    return dict(out, **decode_readings(cs))


def decode_readings(cs) -> dict:
    """ms a decode step of `generate` and the batcher (module docstring)."""
    import numpy as np
    import torch

    from kalle_tpu_torch.data.tokens import build_prompt_ids, build_tokenizer
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher

    cfg = cs.flagship_cfg()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = cs.flagship_int8(g)
    ids = torch.randint(0, 128255, (32, 32), generator=g, device="cuda")
    mask = torch.ones((32, 32), dtype=torch.int32, device="cuda")
    out = {}
    gen_ms = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(params, cfg, ids, mask, torch.Generator(device="cuda").manual_seed(i),
                 max_frames=128)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) / 128 * 1e3)
    out["generate_ms_per_step"] = gen_ms[1:]
    tok = build_tokenizer()
    prompts = [np.asarray(build_prompt_ids(tok, t))
               for t in cs.serve_texts(64, np.random.default_rng(0))]
    for b in (32, 8):
        vals = []
        for _ in range(2):
            cb = ContinuousBatcher(params, cfg, batch_size=b, max_frames=128,
                                   prompt_buckets=(16, 32, 64, 128), seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cb.run(prompts)
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t0) / cb.step_count * 1e3)
        out[f"serve_b{b}_ms_per_step"] = vals
    return out


def main(argv) -> int:
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    after_training = "--after-training" in flags
    if "--one" in flags and len(args) == 1:
        out = measure(args[0], after_training)
        print(json.dumps(dict(tree=args[0], **out)), flush=True)
        return 0
    if len(args) != 2 or set(flags) - {"--after-training"}:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = args
    pooled = {"parent": {}, "change": {}}
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                             + flags, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode or 1
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(line, role=name)), flush=True)
        for k, v in line.items():
            if k != "tree":
                pooled[name].setdefault(k, []).extend(v)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    print(json.dumps({role: {k: {"min": min(v), "median": statistics.median(v),
                                 "max": max(v), "n": len(v)} for k, v in p.items()}
                      for role, p in pooled.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
