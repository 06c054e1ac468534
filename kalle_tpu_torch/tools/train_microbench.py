"""Training-step microbenchmark of the port (counterpart of
tools/train_microbench.py): the flagship Llasa (core/config.flagship_cfg;
f32 master weights and bf16 compute, as train/trainer.Trainer trains it) on
one card, swept over (batch, bucket, remat, flash) through the real
train/step.train_step (loss, gradients, AdamW update).

Prints for each config ms a step, tokens/s, peak device memory and MFU:
6 * N * tokens/s over the H100's dense bf16 peak of 989 TFLOP/s, N the
parameters but the embedding table (its gather is no matmul). A step is
timed on the host clock over --iters steps after one warm-up step, ending
in a device synchronize. A config that runs out of device memory prints
FAILED and the sweep goes on.

    python -m kalle_tpu_torch.tools.train_microbench [--configs b8,t512,flash b8,t512,flash,remat ...]
    python -m kalle_tpu_torch.tools.train_microbench --tiny --device cpu --configs b2,t64 --iters 1

A config: b<batch>,t<bucket>[,flash][,remat][,dots][,a<accum>] — remat
recomputes each layer in the backward (remat_policy "full"), dots keeps the
matmul outputs and recomputes the rest; a<N> stacks N microbatches a step
(tokens a step = N * b * t). --breakdown adds the forward alone and the
forward + backward (no optimizer) of one microbatch; --profile DIR writes a
torch.profiler trace of 4 steps of the first config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

DEFAULT_CONFIGS = ["b8,t512,flash", "b16,t512,flash", "b4,t1024,flash",
                   "b8,t1024,flash,remat", "b2,t2048,flash,remat"]


def synthetic_batch(cfg, b: int, text_len: int, audio_len: int, bucket: int, seed: int = 0):
    """A collated batch of random ids and latents (copy of
    `__graft_entry__._synthetic_batch`)."""
    from ..data.collate import Item, collate

    rng = np.random.default_rng(seed)
    items = []
    for _ in range(b):
        ids = rng.integers(0, min(128255, cfg.llama.vocab_size - 9), (text_len,)).astype(np.int32)
        lat = rng.normal(size=(audio_len, cfg.latent_dim)).astype(np.float32)
        dist = rng.normal(size=(audio_len, cfg.head_out_dim)).astype(np.float32)
        items.append(Item(input_ids=ids, audio_latents=lat, audio_distribution=dist))
    return collate(items, pad_token_id=min(128001, cfg.llama.vocab_size - 1), buckets=(bucket,))


def parse(spec: str):
    parts = spec.split(",")
    num = lambda c, d: next((int(p[1:]) for p in parts if p.startswith(c) and p[1:].isdigit()),
                            d)
    return {"b": int(parts[0][1:]), "t": int(parts[1][1:]), "accum": num("a", 1),
            "flash": "flash" in parts, "remat": "remat" in parts or "dots" in parts,
            "policy": "dots" if "dots" in parts else "full"}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS)
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the forward alone and forward + backward of one "
                         "microbatch")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler trace of 4 steps of the first config here")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..bridge import tree_leaves
    from ..core.config import LlasaConfig, TrainConfig, flagship_cfg
    from ..models.lm import llasa
    from ..train.step import loss_fn, make_train_state, train_step
    from ..train.trainer import device_batch
    from .common import H100_BF16_FLOP_PER_S, device, sync

    dev = device(args.device)
    out = []
    for spec in args.configs:
        c = parse(spec)
        base = LlasaConfig.tiny() if args.tiny else flagship_cfg(param_dtype="float32")
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, remat=c["remat"], remat_policy=c["policy"],
            use_flash_attention=c["flash"]))
        tcfg = TrainConfig(lr=1e-4, warmup_steps=10, total_steps=1000,
                           gradient_accumulation_steps=c["accum"])
        state = batch = None
        try:
            params = llasa.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            n_params = sum(t.numel() for t in tree_leaves(params)) \
                - params["llama"]["embed"].numel()
            state = make_train_state(params, tcfg)
            np_batch = synthetic_batch(cfg, c["b"], 32, c["t"] - 64, c["t"])
            batch = device_batch(np_batch, dev)
            if c["accum"] > 1:
                batch = {k: v[None].expand((c["accum"],) + v.shape).contiguous()
                         for k, v in batch.items()}
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            m = train_step(state, cfg, tcfg, batch, seed=1)  # warm-up
            float(m["total_loss"])
            if args.profile and spec == args.configs[0]:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if dev.type == "cuda" else [])
                with profile(activities=acts) as prof:
                    for _ in range(4):
                        train_step(state, cfg, tcfg, batch, seed=1)
                    sync(dev)
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.profile, "train_trace.json"))
                print(f"# trace -> {args.profile}", flush=True)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                m = train_step(state, cfg, tcfg, batch, seed=1)
            loss = float(m["total_loss"])  # the fence
            dt = (time.perf_counter() - t0) / args.iters
        except torch.cuda.OutOfMemoryError as e:
            print(f"{spec:28s} FAILED: OutOfMemoryError: {str(e)[:90]}", flush=True)
            del state, batch
            torch.cuda.empty_cache()
            continue
        toks = c["accum"] * c["b"] * c["t"]
        mfu = 6 * n_params * toks / dt / H100_BF16_FLOP_PER_S
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
        line = {"config": spec, "ms_per_step": round(dt * 1e3, 2),
                "tokens_per_s": round(toks / dt, 1), "mfu": round(mfu, 4),
                "peak_mem_gb": None if peak is None else round(peak, 2),
                "loss": round(loss, 4), "tokens_per_step": toks, "n_params": n_params}
        print(json.dumps(line), flush=True)
        out.append(line)

        if args.breakdown:
            one = ({k: v[0] for k, v in batch.items()} if c["accum"] > 1 else batch)
            toks_micro = c["b"] * c["t"]

            def noise_gen():  # the sigma head's latent noise
                return torch.Generator(device=dev).manual_seed(1)

            def fwd():
                with torch.no_grad():
                    return loss_fn(state.params, cfg, tcfg, one, noise_gen())[0]

            def fwd_bwd():
                loss = loss_fn(state.params, cfg, tcfg, one, noise_gen())[0]
                loss.backward()
                state.optimizer.zero_grad(set_to_none=True)
                return loss.detach()

            for name, fn, nf in (("fwd", fwd, 2), ("fwd+bwd", fwd_bwd, 6)):
                float(fn())
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    r = fn()
                float(r)
                d = (time.perf_counter() - t0) / args.iters
                row = {"config": spec, "part": name, "ms": round(d * 1e3, 2),
                       "mfu": round(nf * n_params * toks_micro / d / H100_BF16_FLOP_PER_S, 4)}
                print(json.dumps(row), flush=True)
                out.append(row)
        del state, batch
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
