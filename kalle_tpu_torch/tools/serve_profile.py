"""The continuous-batching decode step alone (counterpart of
tools/serve_profile.py): infer/serve_loop.decode_step at the flagship's
widths (random bf16 weights from a seeded torch.Generator; --int8 for
int8 layer weights), every row filled through the batcher's real prefill
and insert with prompts of 8-59 ids, so each row writes its KV at its own
slot (ragged lengths), and a share of the rows (--occupancy) left live.

decode_step is where serving differs from `generate`: K1 runs in its
sideband mode (the pre-update cache plus this step's K/V column) and the
rows' lengths differ. The step is timed as the batcher runs it, eagerly,
with CUDA events around --steps steps after a warm-up from the same
snapshot of the state, so the host's issue cost is in the number.
--profile DIR writes a torch.profiler trace of 16 steps.

    python -m kalle_tpu_torch.tools.serve_profile --batch 8 --steps 128 [--int8] [--profile DIR]
    python -m kalle_tpu_torch.tools.serve_profile --tiny --device cpu --steps 4

Prints one JSON line with the JAX tool's keys (kernel_min_batch is null:
the port has no such gate); `main` returns it with the decode_step calls
made (each a launch of K1 a layer on the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--max-frames", type=int, default=160)
    ap.add_argument("--kernel-min-batch", type=int, default=None,
                    help="the JAX package's decode-attention batch gate; the port has "
                         "none (K1 runs at every batch on the card), so giving it raises")
    ap.add_argument("--int8", action="store_true", help="int8 weights")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV cache")
    ap.add_argument("--occupancy", type=float, default=0.75,
                    help="fraction of rows active (ragged lengths)")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler trace of 16 steps here")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.kernel_min_batch is not None:
        raise ValueError("--kernel-min-batch: the port has no decode-attention batch gate; "
                         "K1 runs at every batch on the card")

    from ..bridge import tree_map
    from ..core.config import LlasaConfig, flagship_cfg, torch_dtype
    from ..infer.serve_loop import ContinuousBatcher, decode_step
    from ..models.lm import llasa
    from ..ops.quant import quantize_llama_params
    from .common import device, sync

    dev = device(args.device)
    cfg = LlasaConfig.tiny() if args.tiny else flagship_cfg()
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama,
                                                                 kv_cache_dtype="int8"))
    dt = torch_dtype(cfg.llama.dtype)
    params = tree_map(lambda t: t.to(dt),
                      llasa.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    if args.int8:
        params = quantize_llama_params(params)

    B = args.batch
    rng = np.random.default_rng(0)
    cb = ContinuousBatcher(params, cfg, batch_size=B, max_frames=args.max_frames,
                           prompt_buckets=(16, 32, 64), device=dev)
    for r, n in enumerate(rng.integers(8, 60, (B,))):
        cb._admit(r, r, rng.integers(1, cfg.llama.vocab_size - 9, (n,)).astype(np.int64))
    n_act = max(1, int(round(B * args.occupancy)))
    cb.state.active[n_act:] = False
    snap = {f.name: getattr(cb.state, f.name) for f in dataclasses.fields(cb.state)}
    snap = {k: None if v is None else v.clone() for k, v in snap.items()}
    calls = [0]

    def restore():
        for k, v in snap.items():
            if v is not None:
                getattr(cb.state, k).copy_(v)

    def run(n):
        for _ in range(n):
            decode_step(params, cb.state, cfg, cb.generator)
            calls[0] += 1

    steps = min(args.steps, args.max_frames - 1)  # a live row stays live throughout
    run(steps)  # warm-up
    sync(dev)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        restore()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            run(16)
            sync(dev)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, f"serve_b{B}.json"))
        print(f"trace written to {args.profile}")
    restore()
    sync(dev)
    if dev.type == "cuda":
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        run(steps)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / steps
    else:
        t0 = time.perf_counter()
        run(steps)
        ms = (time.perf_counter() - t0) * 1e3 / steps
    line = {"metric": "serve_decode_step", "batch": B, "active_rows": n_act, "steps": steps,
            "ms_per_step": round(ms, 3), "cache_len": int(cb.state.k.shape[-1]),
            "kernel_min_batch": None, "int8_w": args.int8, "int8_kv": args.int8_kv}
    print(json.dumps(line), flush=True)
    return {**line, "calls": calls[0]}


if __name__ == "__main__":
    main()
