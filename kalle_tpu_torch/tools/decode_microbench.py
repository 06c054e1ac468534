"""Decode-step microbenchmark of the port (counterpart of
tools/decode_microbench.py): where the autoregressive decode step's time
goes, at the flagship's widths (core/config.flagship_cfg, random bf16
weights from a seeded torch.Generator), batch B, one frame a step.

  weights    the 7 layer matmuls x 16 layers on a (B, 2048) activation and
             nothing else (no attention, cache, norms): the weight-streaming
             floor; int8 weights (--int8) go through K2 (wq, wk, wv, wo) and
             K3 (the MLP), as the decode step sends them
  step       one whole decode step: llama.forward_with_cache at t=1 over a
             cache of 32 + 128 valid slots (256 allocated) + the head + the
             audio projection back to the next input
  step_nokv  the same over a cache of 128 slots, to isolate the KV-cache cost
  gen        infer.generate.generate over --steps frames, per frame (prefill
             of 32 ids included, the host's per-frame stop test too)

The JAX tool times a chained jitted loop to keep host dispatch out. Here
`weights`, `step` and `step_nokv` chain --steps calls (each call's output
is the next call's input, the cache position held fixed: the step writes
one slot and `KVCache.length`, a Python int, is set back after it) and
capture them into one CUDA graph, whose replays are timed with CUDA
events (tools/common.device_ms). `gen` is timed eagerly with events
around whole calls. This is a measurement harness, not a capture of
`generate` for serving.

    python -m kalle_tpu_torch.tools.decode_microbench [--batch 32] [--int8] [--steps 32]
    python -m kalle_tpu_torch.tools.decode_microbench --tiny --device cpu --steps 2

Prints one JSON line per variant (ms a step, GB/s of the weights (+ KV)
streamed, the bound of those bytes at H100 HBM rate, how it was timed);
`main` returns them, each with `runs`: the times its step ran (the
warm-up, then each replayed or eager call; `gen`: its generate calls).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch


def _layer_bytes(layers) -> int:
    from ..bridge import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(layers))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="int4 g128 weight-only (group-wise scales; the plain route)")
    ap.add_argument("--fused", action="store_true", help="fused wqkv/wgu decode weight layout")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV cache with per-token scales")
    ap.add_argument("--kernel-min-batch", type=int, default=None,
                    help="the JAX package's decode-attention batch gate; the port has "
                         "none (K1 runs at every batch on the card), so giving it raises")
    ap.add_argument("--steps", type=int, default=32,
                    help="chained steps a captured graph (and frames of `gen`)")
    ap.add_argument("--iters", type=int, default=3, help="timed replays")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.kernel_min_batch is not None:
        raise ValueError("--kernel-min-batch: the port has no decode-attention batch gate; "
                         "K1 runs at every batch on the card")

    from ..bridge import tree_map
    from ..core.config import LlasaConfig, flagship_cfg, torch_dtype
    from ..infer.generate import generate
    from ..models.lm import llama, llasa
    from ..ops.quant import fuse_decode_params, quantize_llama_params
    from .common import H100_HBM_BYTES_PER_S, device, device_ms

    dev = device(args.device)
    cfg = LlasaConfig.tiny() if args.tiny else flagship_cfg()
    lcfg = cfg.llama
    if args.int8_kv:
        lcfg = dataclasses.replace(lcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, llama=lcfg)
    dt = torch_dtype(lcfg.dtype)
    B, K = args.batch, args.steps
    g = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda t: t.to(dt), llasa.init_params(cfg, g, dev))
    if args.int4:
        params = quantize_llama_params(params, bits=4)
    elif args.int8:
        params = quantize_llama_params(params)
    if args.fused:
        params = fuse_decode_params(params)
    stream_b = _layer_bytes(params["llama"]["layers"])
    print(f"batch={B} int8={args.int8} int4={args.int4} fused={args.fused} "
          f"streamed weights {stream_b / 1e9:.3f} GB", flush=True)
    layers = llama.layer_params(params["llama"]["layers"])
    out = []

    def emit(variant, ms, how, runs, nbytes, extra=None):
        line = {"variant": variant, "batch": B, "ms_per_step": round(ms, 4),
                "gb_per_s": round(nbytes / (ms * 1e-3) / 1e9, 1),
                "bound_ms": round(nbytes / H100_HBM_BYTES_PER_S * 1e3, 4),
                "bound_by": "bytes", "timing": how, "int8": args.int8, "int4": args.int4,
                "fused": args.fused, "int8_kv": args.int8_kv, **(extra or {})}
        print(json.dumps(line), flush=True)
        out.append({**line, "runs": runs})

    state = {"x": torch.ones((B, 1, lcfg.hidden_size), dtype=dt, device=dev)}

    def weights_only():
        x = state["x"]
        for lp in layers:
            q, k, v = llama._qkv(lcfg, x, lp, True)
            x = x + llama._proj(q.reshape(B, 1, -1), lp["wo"], True)
            x = x + llama.mlp_block(x, lp, True) + k.sum() + v.sum()
        state["x"] = x

    ms, how, runs = device_ms(weights_only, K, dev, args.iters)
    emit("weights", ms, how, runs, stream_b)

    def cache_step(cache_len: int, n_valid: int):
        cache = llama.KVCache.zeros(lcfg, B, cache_len, device=dev)
        valid = torch.zeros((B, cache_len), dtype=torch.bool, device=dev)
        valid[:, :n_valid] = True
        pos = torch.full((B, 1), n_valid - 1, dtype=torch.long, device=dev)
        state = {"emb": torch.ones((B, 1, lcfg.hidden_size), dtype=dt, device=dev)}

        def step():
            cache.length = n_valid - 1  # the same slot every step
            h, _ = llama.forward_with_cache(params["llama"], lcfg, state["emb"], cache,
                                            attention_mask=valid, positions=pos)
            mean = llasa.distribution_head(params, h, dt)
            state["emb"] = llasa.audio_proj(params, mean, dt)

        kv_b = cache.k.numel() * cache.k.element_size() * 2 * n_valid // cache_len
        return step, kv_b

    for variant, (c, n) in (("step", (256, 32 + 128)), ("step_nokv", (128, 128))):
        step, kv_b = cache_step(c, n)
        ms, how, runs = device_ms(step, K, dev, args.iters)
        emit(variant, ms, how, runs, stream_b + kv_b, {"cache_len": c, "valid_slots": n})

    ids = torch.randint(0, lcfg.vocab_size - 9, (B, 32), generator=g, device=dev)
    mask = torch.ones((B, 32), dtype=torch.int32, device=dev)

    def gen():
        generate(params, cfg, ids, mask, torch.Generator(device=dev).manual_seed(1),
                 max_frames=K, end_kl_threshold=-1.0)

    gen()  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(args.iters):
            gen()
        e1.record()
        e1.synchronize()
        ms, how = e0.elapsed_time(e1) / (args.iters * K), "eager_events"
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            gen()
        ms, how = (time.perf_counter() - t0) * 1e3 / (args.iters * K), "host"
    emit("gen", ms, how, 1 + args.iters, stream_b, {"frames": K})
    return out


if __name__ == "__main__":
    main()
