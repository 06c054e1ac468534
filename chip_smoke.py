"""Chip smoke test of the PyTorch/CUDA port (kalle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):
  1. build the hand-written kernels from csrc/ (one nvcc per source, all at
     once) and print the toolchain and the card (nvidia-smi name, power
     limit);
  2. hold every kernel against its plain PyTorch version on the same inputs
     at the shapes the main path gives it, and time kernel, plain version
     and, where one exists, the single PyTorch call that computes the same
     function (a captured CUDA graph's replay, timed with CUDA events);
  3. drive the main path — text -> latents -> 24 kHz wav — at bench.py's
     shape: the 1B Llama-3.2-shape Llasa (random weights from a seeded
     torch.Generator, bf16, int8 layer weights, sigma head, 64-d latents),
     batch 32, 32 text ids, 128 frames, bf16 SigmaVAE decode; the early-stop
     arm; then 3 timed iterations with every kernel's launch count read and
     checked, one profiled run (device time by kernel, busy share), and a
     small-input check of the card's path against the port's plain CPU path;
  4. train the full-width model (16 layers, hidden 2048, f32 master weights,
     bf16 compute, sigma head) through the port's Trainer.fit on synthetic
     sigma latents: batch 8 at bucket 512, 2 microbatches a step, flash
     attention K5-K7 in every layer's forward and backward. Checks finite
     losses, that the weights moved, that the final checkpoint restores and
     K5-K7's launch counts; prints ms a step, tokens/s, the model-FLOPs
     share, peak memory and the busy share of one profiled step. Then one
     train_step of a small model on the card and on the CPU (plain
     versions): loss and grads agree;
  5. serve the full-width int8 model (bf16, sigma head) by continuous
     batching: ContinuousBatcher.run of 64 requests (prompts of 20-120
     byte-tokenizer ids, 128 frames, all arriving at once) at batch 32 and
     at batch 8, printing requests/s, frames/s, ms a decode step and every
     kernel's launches (K1 in its sideband mode, K2, K3 in every step), and
     a profile of one batch-32 run; greedy completions of the batcher
     against `generate` (fed the batcher's left-padded bucket prompts) on
     the card for 4 prompts over 16 frames (in f32 all 16 frames within
     1e-3; in bf16 with int8 weights frames 0-7 within max(2e-2, 4x the
     drift of a rerun of `generate`), the rest printed); then serve_http
     on port 0 with the real BatcherService (batch 8, chunks of 25
     frames) and the bf16 SigmaVAE: eight concurrent GET /tts clients,
     each body the wav header and
     exactly (128 - 1) * 3200 * 2 PCM bytes, with time to first audio and
     total seconds a request.

Phase 2 also holds K5-K7 (flash attention forward, dq, dk/dv) against
their plain versions at the flagship training shape (b 8, t 512, 32/8
heads, hd 64, bf16; ragged pads, a left-padded row, a row with no valid
key) and K5 at hd 128 (b 4, 16/4 heads), K1's sideband mode at phase 5's
shapes (batch 8 and 32, cache 384, ragged rows, some rows' new column not
counted), K2 at M 8, 32 and 72 and K3 at both serving batches, M 8 and 32
(the kernels line keeps M 32), and, once each, the inputs that raised
before C3's repair: K1 at 16 query heads a KV head and hd 256 in all three
modes, K2/K3 with f32 activations, and the tiny f32 config with int8
weights decoding on the card against the CPU. Launch counts: K1-K4 from
phase 3's run, K5-K7 from phase 4's, K1's sideband from phase 5's
batch-32 run.

Prints a `kernels` JSON line, the card line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Needs a CUDA card, nvcc, and nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
BATCH, TEXT_LEN, MAX_FRAMES, LATENT_HZ = 32, 32, 128, 7.5
ITERS = 3
# phase 4: batch rows, bucket length, microbatches a step, optimizer steps
TRAIN_B, TRAIN_T, TRAIN_A, TRAIN_STEPS = 8, 512, 2, 10
# phase 5: requests, frames a request, the batcher's prompt buckets and its
# cache length (the largest bucket plus max_frames + 1, rounded up to 128)
SERVE_REQS, SERVE_FRAMES, SERVE_BUCKETS = 64, 128, (16, 32, 64, 128)
SERVE_CACHE = -(-(SERVE_BUCKETS[-1] + SERVE_FRAMES + 1) // 128) * 128


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls are captured into a CUDA graph
    and one replay is timed with CUDA events, so the host's launch cost (tens
    of µs of Python a wrapper call) does not hide the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


def event_ms(fn, iters: int) -> float:
    """Device time of one call timed with CUDA events around `iters` calls,
    no graph (for calls that run autograd)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def each_layer(fn, n_layers: int):
    """fn(i) over layers 0, 1, ... in turn, so each call finds its layer of
    a stacked cache or weight cold in L2."""
    layers = itertools.count()
    return lambda: fn(next(layers) % n_layers)


# --------------------------------------------------------------- phase 1 ----

def phase_build():
    from kalle_tpu_torch.ops.kernels import _build

    log("# phase 1: build and environment")
    t0 = time.perf_counter()
    per = _build.build()
    log(f"build_s {time.perf_counter() - t0:.2f} per_source "
        + json.dumps({k: round(v, 2) for k, v in per.items()}))
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in lib.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib.stem}: {line.strip()}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc '{nv[-1] if nv else None}' "
        f"cutlass {os.path.exists('/usr/local/cutlass/include/cutlass/cutlass.h')} "
        f"triton {triton_v}")
    log(f"card {card_line()}")


# --------------------------------------------------------------- phase 2 ----

def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def _assert_close(name, got, ref, atol, rtol):
    if not torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {_max_err(got, ref):.4g})")


def check_decode_attention(g):
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain)

    L, B, C, nq, nkv, hd = 16, BATCH, 256, 32, 8, 64
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(L, B, nq, hd, generator=g, device=dev).to(bf)
    kt = torch.randn(L, B, nkv, hd, C, generator=g, device=dev).to(bf)
    v = torch.randn(L, B, nkv, C, hd, generator=g, device=dev).to(bf)
    # the main path's last step: 32 prompt slots (some left-padded) + 128 frames
    n_pad = torch.randint(0, 8, (B,), generator=g, device=dev)
    pos = torch.arange(C, device=dev)[None]
    mask = (pos >= n_pad[:, None]) & (pos < TEXT_LEN + MAX_FRAMES)

    ref = decode_attention_plain(q[7], kt, v, 7, mask)
    got = decode_attention_cached(q[7], kt, v, 7, mask)
    _assert_close("decode_attention", got, ref, 2e-2, 2e-2)
    err = _max_err(got, ref)

    # int8 cache variant: per-(token, head) absmax scales
    ks = kt.float().abs().amax(dim=3, keepdim=True).clamp_min(1e-8) / 127
    vs = v.float().abs().amax(dim=4, keepdim=True).clamp_min(1e-8) / 127
    kq = torch.round(kt.float() / ks).to(torch.int8)
    vq = torch.round(v.float() / vs).to(torch.int8)
    vs = vs.transpose(-1, -2).contiguous()
    ref8 = decode_attention_plain(q[7], kq, vq, 7, mask, ks, vs)
    got8 = decode_attention_cached(q[7], kq, vq, 7, mask, ks, vs)
    _assert_close("decode_attention int8", got8, ref8, 2e-2, 2e-2)
    log(f"  decode_attention int8 cache: max_abs_err {_max_err(got8, ref8):.4g}")

    # time over all 16 layers so each call finds its layer cold in L2
    kern = cuda_ms(each_layer(lambda i: decode_attention_cached(q[i], kt, v, i, mask), L), 64)
    plain = cuda_ms(each_layer(lambda i: decode_attention_plain(q[i], kt, v, i, mask), L), 16)
    lib_ms = None
    try:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        am = mask[:, None, None, :]
        lib_ms = cuda_ms(each_layer(lambda i: sdpa(
            q[i][:, :, None], kt[i].transpose(-1, -2), v[i], attn_mask=am,
            enable_gqa=True), L), 64)
    except TypeError as e:  # a torch without enable_gqa
        log(f"  sdpa not timed: {e}")
    n_valid = int(mask.sum())
    nbytes = (n_valid * nkv * hd * 2 * 2          # K and V of the valid slots
              + 2 * B * nq * hd * 2 + B * C)      # q, out, mask
    flops = 4 * n_valid * nq * hd
    return dict(name="decode_attention", source="kalle_tpu_torch/csrc/decode_attention.cu",
                replaces="kalle_tpu/ops/pallas/decode_attention.py:320",
                max_abs_err=err, ms=kern, plain_ms=plain, library_ms=lib_ms,
                work=(nbytes, flops))


def check_decode_attention_sideband(g):
    """K1's serving mode at phase 5's shapes: 16 layers, cache 384, batch 8
    and 32. Row r holds a left-padded prompt of 20..bucket ids in a bucket
    of 32, 64 or 128 slots, then 0..127 frames; this step's column goes to
    the slot after them, and about a quarter of the rows (and row 1) do not
    count it. Returns the batch-32 row; batch 8 is logged."""
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain)

    L, C, nq, nkv, hd = 16, SERVE_CACHE, 32, 8, 64
    dev, bf = "cuda", torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = None
    for B in (8, 32):
        q = torch.randn(L, B, nq, hd, generator=g, device=dev).to(bf)
        kt = torch.randn(L, B, nkv, hd, C, generator=g, device=dev).to(bf)
        v = torch.randn(L, B, nkv, C, hd, generator=g, device=dev).to(bf)
        kn, vn = (torch.randn(L, B, nkv, hd, generator=g, device=dev).to(bf) for _ in range(2))
        bucket = torch.tensor((32, 64, 128), device=dev)[
            torch.randint(0, 3, (B,), generator=g, device=dev)]
        n_ids = 20 + (torch.rand(B, generator=g, device=dev) * (bucket - 19)).long()
        n_gen = torch.randint(0, SERVE_FRAMES, (B,), generator=g, device=dev)
        pos = torch.arange(C, device=dev)[None]
        mask = (((pos >= (bucket - n_ids)[:, None]) & (pos < bucket[:, None]))
                | ((pos >= bucket[:, None]) & (pos < (bucket + n_gen)[:, None])))
        slot = bucket + n_gen
        live = torch.rand(B, generator=g, device=dev) > 0.25
        live[1] = False

        def kernel(i):
            return decode_attention_cached(q[i], kt, v, i, mask, k_new=kn[i], v_new=vn[i],
                                           new_valid=live)

        def plain(i):
            return decode_attention_plain(q[i], kt, v, i, mask, k_new=kn[i], v_new=vn[i],
                                          new_valid=live)

        got, ref = kernel(7), plain(7)
        _assert_close(f"decode_attention_sideband B={B}", got, ref, 2e-2, 2e-2)
        err = _max_err(got, ref)
        # SDPA computes the same function in one call over a cache with the
        # column written at each row's slot and counted where it is live
        rows = torch.arange(B, device=dev)
        kt2, v2 = kt.clone(), v.clone()
        kt2[:, rows, :, :, slot] = kn.transpose(0, 1)
        v2[:, rows, :, slot, :] = vn.transpose(0, 1)
        post = mask.clone()
        post[rows, slot] |= live
        am = post[:, None, None, :]
        k_ms = cuda_ms(each_layer(kernel, L), 64)
        p_ms = cuda_ms(each_layer(plain, L), 16)
        lib_ms = cuda_ms(each_layer(lambda i: sdpa(
            q[i][:, :, None], kt2[i].transpose(-1, -2), v2[i], attn_mask=am,
            enable_gqa=True), L), 64)
        n_keys = int(mask.sum()) + int(live.sum())
        nbytes = (n_keys * nkv * hd * 2 * 2           # K and V of the keys that count
                  + 2 * B * nq * hd * 2 + B * C + B)  # q, out, mask, new_valid
        flops = 4 * n_keys * nq * hd
        b_ms, b_by = bound(nbytes, flops)
        log(f"  decode_attention_sideband B={B} C={C}: kernel_ms {k_ms:.4f} plain_ms "
            f"{p_ms:.4f} sdpa_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
            f"max_abs_err {err:.4g} (tolerance 2e-2 abs + 2e-2 rel)")
        row = dict(name="decode_attention_sideband",
                   source="kalle_tpu_torch/csrc/decode_attention.cu",
                   replaces="kalle_tpu/ops/pallas/decode_attention.py:320",
                   max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   work=(nbytes, flops), note=f"batch {B}, cache {C}, sideband mode")
        del q, kt, v, kn, vn, kt2, v2
        torch.cuda.empty_cache()
    return row


def _int8_layers(g, L, k, n):
    w = torch.randn(L, k, n, generator=g, device="cuda") * 0.02
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127
    return torch.round(w / scale[:, None]).to(torch.int8), scale


def _x_rows(g, H):
    """Activations at each serving batch (8 and 32; phase 3 runs 32): the
    32 rows from `g`, the 8 from a generator of their own."""
    g8 = torch.Generator(device="cuda").manual_seed(8)
    return {BATCH: torch.randn(BATCH, H, generator=g, device="cuda").to(torch.bfloat16),
            8: torch.randn(8, H, generator=g8, device="cuda").to(torch.bfloat16)}


def log_row(r):
    """Turn a row's work into its bound and log it."""
    nbytes, flops = r.pop("work")
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    log(f"  {r['name']}: kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']} bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}) max_abs_err {r['max_abs_err']:.4g} {r.get('note', '')}")


def check_qmm(g):
    """K2 at both serving batches (M 8 and 32 pick different instances) and
    at M 72 (two row tiles, the second ragged); the row of the kernels line
    is M = 32, M = 8 and 72 are logged, each projection's time too."""
    from kalle_tpu_torch.ops.kernels.qmm import qmm, qmm_plain

    L, H = 16, 2048
    shapes = {"wq": (H, 2048), "wk": (H, 512), "wv": (H, 512), "wo": (2048, H)}
    ws = {k: _int8_layers(g, L, *s) for k, s in shapes.items()}
    deq = {k: (q.float() * s[:, None]).to(torch.bfloat16) for k, (q, s) in ws.items()}
    xs = _x_rows(g, H)
    xs[72] = torch.randn(72, H, generator=g, device="cuda").to(torch.bfloat16)
    rows = {}
    for M, x in sorted(xs.items()):
        err = 0.0
        for name, (q, s) in ws.items():
            got, ref = qmm(x, q[5], s[5]), qmm_plain(x, q[5], s[5])
            rel = _rel_err(got, ref)
            if rel > 1e-2:
                raise AssertionError(f"qmm {name} M={M}: relative error {rel:.4g} > 1e-2")
            err = max(err, _max_err(got, ref))
        li = iter(range(10 ** 9))

        def layer_of(fn):
            def run():
                i = next(li) % L
                for name in shapes:
                    fn(name, i)
            return run

        kern = cuda_ms(layer_of(lambda n, i: qmm(x, ws[n][0][i], ws[n][1][i])), 64)
        plain = cuda_ms(layer_of(lambda n, i: qmm_plain(x, ws[n][0][i], ws[n][1][i])), 16)
        lib = cuda_ms(layer_of(lambda n, i: torch.matmul(x, deq[n][i])), 64)
        each = {}
        for name in ("wq", "wk", "wo"):  # wv is wk's shape
            each[name] = (
                cuda_ms(each_layer(lambda i: qmm(x, ws[name][0][i], ws[name][1][i]), L), 64),
                cuda_ms(each_layer(lambda i: torch.matmul(x, deq[name][i]), L), 64))
        log(f"  qmm M={M} per projection, kernel_ms / matmul_ms: " + " ".join(
            f"{n} {k:.4f} / {m:.4f}" for n, (k, m) in each.items()))
        nbytes = sum(k * n + n * 4 + M * k * 2 + M * n * 2 for k, n in shapes.values())
        flops = sum(2 * M * k * n for k, n in shapes.values())
        rows[M] = dict(name="qmm", source="kalle_tpu_torch/csrc/qmm.cu",
                       replaces="kalle_tpu/ops/pallas/qmm.py:74", max_abs_err=err,
                       ms=kern, plain_ms=plain, library_ms=lib, work=(nbytes, flops),
                       note=f"one layer's wq+wk+wv+wo, M={M}, int8 (tolerance 1e-2 relative)")
    log_row(rows[8])
    log_row(rows[72])
    return rows[BATCH]


def check_fused_mlp(g):
    """K3 at both serving batches, as check_qmm."""
    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp, fused_mlp_plain

    L, H, F = 16, 2048, 8192
    wg, wu, wd = (_int8_layers(g, L, *s) for s in ((H, F), (H, F), (F, H)))

    def layer(i):
        return [{"q": q[i], "scale": s[i]} for q, s in (wg, wu, wd)]

    rows = {}
    for M, x in sorted(_x_rows(g, H).items()):
        got, ref = fused_mlp(x, *layer(5)), fused_mlp_plain(x, *layer(5))
        rel = _rel_err(got, ref)
        if rel > 1e-2:
            raise AssertionError(f"fused_mlp M={M}: relative error {rel:.4g} > 1e-2")
        li = iter(range(10 ** 9))
        kern = cuda_ms(lambda: fused_mlp(x, *layer(next(li) % L)), 64)
        plain = cuda_ms(lambda: fused_mlp_plain(x, *layer(next(li) % L)), 16)
        nbytes = 3 * H * F + (2 * F + H) * 4 + 2 * M * H * 2
        rows[M] = dict(name="fused_mlp", source="kalle_tpu_torch/csrc/qmm.cu",
                       replaces="kalle_tpu/ops/pallas/qmm.py:151",
                       max_abs_err=_max_err(got, ref), ms=kern, plain_ms=plain,
                       library_ms=None, work=(nbytes, 3 * 2 * M * H * F),
                       note=f"one layer, M={M}, int8 (tolerance 1e-2 relative)")
    log_row(rows[8])
    return rows[BATCH]


# SigmaVAE decoder residual blocks at batch 32, 128 frames: (C, T)
CONVNEXT_SHAPES = ((512, 128), (512, 1024), (256, 5120), (128, 25600), (64, 102400))


def check_convnext(g):
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.ops.kernels.convnext_block import (
        convnext_block, convnext_block_plain)

    cfg = sigmavae.SigmaVAEConfig()
    tot = dict(ms=0.0, plain_ms=0.0, err=0.0, nbytes=0, flops=0)
    for c, t in CONVNEXT_SHAPES:
        blk = sigmavae.init_params(dataclasses.replace(cfg, channels=(c, c), strides=(4,)),
                                   g, "cuda")["decoder"]["stages"][0]["blocks"][0]
        args = [a.to(torch.bfloat16) for a in (
            blk["norm"], blk["dw"]["w"], blk["dw"]["b"], blk["up"]["w"], blk["up"]["b"],
            blk["down"]["w"], blk["down"]["b"])]
        x = torch.randn(BATCH, t, c, generator=g, device="cuda").to(torch.bfloat16)
        got, ref = convnext_block(x, *args), convnext_block_plain(x, *args)
        _assert_close(f"convnext_block C={c} T={t}", got, ref, 2e-2, 2e-2)
        iters = 20 if t <= 5120 else 5
        k_ms = cuda_ms(lambda: convnext_block(x, *args), iters)
        p_ms = cuda_ms(lambda: convnext_block_plain(x, *args), max(2, iters // 4))
        err = _max_err(got, ref)
        nbytes = 2 * BATCH * t * c * 2 + sum(a.numel() * 2 for a in args)
        flops = BATCH * t * (12 * c * c + 14 * c)
        log(f"  convnext_block C={c} T={t}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {bound(nbytes, flops)[0]:.4f} max_abs_err {err:.4g}")
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["err"] = max(tot["err"], err)
        tot["nbytes"] += nbytes
        tot["flops"] += flops
        del x, got, ref
        torch.cuda.empty_cache()
    return dict(name="convnext_block", source="kalle_tpu_torch/csrc/convnext_block.cu",
                replaces="kalle_tpu/ops/pallas/convnext_block.py:86",
                max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                library_ms=None, work=(tot["nbytes"], tot["flops"]),
                note="sum over one block at each decoder width, batch 32")


def check_flash(g):
    """K5-K7 at the flagship training shape against the plain versions."""
    from kalle_tpu_torch.ops.kernels import flash_attention as fa

    b, t, nq, nkv, hd = TRAIN_B, TRAIN_T, 32, 8, 64
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, t, nq, hd, generator=g, device=dev).to(bf)
    k = torch.randn(b, t, nkv, hd, generator=g, device=dev).to(bf)
    v = torch.randn(b, t, nkv, hd, generator=g, device=dev).to(bf)
    do = torch.randn(b, t, nq, hd, generator=g, device=dev).to(bf)
    lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
    pad = (torch.arange(t, device=dev)[None] < lens[:, None]).to(torch.int32)
    pad[1, :100] = 0   # left padded: queries 0..99 see no valid key
    pad[2] = 0         # a row with no valid key
    pad[3] = 1         # one full row

    o, lse = fa.flash_fwd(q, k, v, pad)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, pad)
    _assert_close("flash_fwd O", o, o_ref, 2e-2, 2e-2)
    masked = lse_ref <= fa.NEG / 2
    if not (torch.equal(lse <= fa.NEG / 2, masked) and torch.all(o[2] == 0)):
        raise AssertionError("flash_fwd: the rows with no valid key differ")
    _assert_close("flash_fwd LSE", lse[~masked], lse_ref[~masked], 1e-3, 1e-4)
    delta = fa.attention_delta(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, pad, do, lse_ref, delta)
    dq_ref = fa.flash_bwd_dq_plain(q, k, v, pad, do, lse_ref, delta)
    _assert_close("flash_bwd_dq", dq, dq_ref, 2e-2, 2e-2)
    dk, dv = fa.flash_bwd_dkv(q, k, v, pad, do, lse_ref, delta)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, pad, do, lse_ref, delta)
    _assert_close("flash_bwd_dkv dK", dk, dk_ref, 2e-2, 2e-2)
    _assert_close("flash_bwd_dkv dV", dv, dv_ref, 2e-2, 2e-2)
    errs = {"flash_fwd": _max_err(o, o_ref), "flash_bwd_dq": _max_err(dq, dq_ref),
            "flash_bwd_dkv": max(_max_err(dk, dk_ref), _max_err(dv, dv_ref))}
    log(f"  flash LSE max_abs_err {_max_err(lse[~masked], lse_ref[~masked]):.4g}; "
        f"dK {_max_err(dk, dk_ref):.4g} dV {_max_err(dv, dv_ref):.4g}")

    # the library yardstick: SDPA (GQA, bool mask), forward and forward+backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(t, device=dev)
    am = ((pos[None, :] <= pos[:, None])[None, None] & pad.bool()[:, None, None, :])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am, enable_gqa=True), 10)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    dot_ = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        sdpa(qg, kg, vg, attn_mask=am, enable_gqa=True).backward(dot_)

    lib_fb = event_ms(sdpa_fwd_bwd, 10)
    log(f"  sdpa (enable_gqa, bool mask): forward_ms {lib_fwd:.4f} "
        f"forward+backward_ms {lib_fb:.4f}")

    # work: the (query, key) pairs this pad mask leaves, per query head
    pairs = float(pad.cumsum(-1).sum()) * nq
    e_qkv = 2 * (q.numel() + k.numel() + v.numel())
    e_stats = 4 * b * nq * t
    rows = []
    for name, replaces, fn, plain, products, nbytes, lib in (
            ("flash_fwd", "kalle_tpu/ops/pallas/flash_attention.py:100",
             lambda: fa.flash_fwd(q, k, v, pad),
             lambda: fa.flash_attention_fwd_plain(q, k, v, pad),
             2, e_qkv + 4 * b * t + 2 * o.numel() + e_stats, lib_fwd),
            ("flash_bwd_dq", "kalle_tpu/ops/pallas/flash_attention.py:207",
             lambda: fa.flash_bwd_dq(q, k, v, pad, do, lse_ref, delta),
             lambda: fa.flash_bwd_dq_plain(q, k, v, pad, do, lse_ref, delta),
             3, e_qkv + 4 * b * t + 2 * do.numel() + 2 * e_stats + 2 * q.numel(), None),
            ("flash_bwd_dkv", "kalle_tpu/ops/pallas/flash_attention.py:226",
             lambda: fa.flash_bwd_dkv(q, k, v, pad, do, lse_ref, delta),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, pad, do, lse_ref, delta),
             4, e_qkv + 4 * b * t + 2 * do.numel() + 2 * e_stats
             + 2 * (k.numel() + v.numel()), None)):
        rows.append(dict(name=name, source="kalle_tpu_torch/csrc/flash_attention.cu",
                         replaces=replaces, max_abs_err=errs[name], ms=cuda_ms(fn, 10),
                         plain_ms=cuda_ms(plain, 3), library_ms=lib,
                         work=(nbytes, pairs * products * 2 * hd)))
    rows[0]["note"] = "SDPA forward as library_ms"
    check_flash_hd128(g)
    return rows


def check_flash_hd128(g):
    """K5's bf16 tensor-core instance at hd 128 (the training shape reaches
    only hd 64): b 4, t 512, 16/4 heads, ragged right padding, a left-padded
    row and a row with no valid key; O 2e-2, LSE 1e-3 abs + 1e-4 rel, the
    dead rows identical. Logged with its plain and SDPA times."""
    from kalle_tpu_torch.ops.kernels import flash_attention as fa

    b, t, nq, nkv, hd = 4, TRAIN_T, 16, 4, 128
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, t, nq, hd, generator=g, device=dev).to(bf)
    k, v = (torch.randn(b, t, nkv, hd, generator=g, device=dev).to(bf) for _ in range(2))
    lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
    pad = (torch.arange(t, device=dev)[None] < lens[:, None]).to(torch.int32)
    pad[1, :77] = 0
    pad[2] = 0
    o, lse = fa.flash_fwd(q, k, v, pad)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, pad)
    _assert_close("flash_fwd hd 128 O", o, o_ref, 2e-2, 2e-2)
    dead = lse_ref <= fa.NEG / 2
    if not (torch.equal(lse <= fa.NEG / 2, dead) and torch.equal(lse[dead], lse_ref[dead])
            and torch.all(o[2] == 0) and torch.all(o[1, :77] == 0)):
        raise AssertionError("flash_fwd hd 128: the rows with no valid key differ")
    _assert_close("flash_fwd hd 128 LSE", lse[~dead], lse_ref[~dead], 1e-3, 1e-4)
    pos = torch.arange(t, device=dev)
    am = (pos[None, :] <= pos[:, None])[None, None] & pad.bool()[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, pad), 10)
    p_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, pad), 3)
    l_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am, enable_gqa=True), 10)
    pairs = float(pad.cumsum(-1).sum()) * nq
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * t + 4 * b * nq * t
    b_ms, b_by = bound(nbytes, pairs * 4 * hd)
    log(f"  flash_fwd hd 128 (b {b}, t {t}, {nq}/{nkv} heads): kernel_ms {k_ms:.4f} "
        f"plain_ms {p_ms:.4f} sdpa_ms {l_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) O max_abs_err "
        f"{_max_err(o, o_ref):.4g} LSE max_abs_err {_max_err(lse[~dead], lse_ref[~dead]):.4g}")


def check_c3(g):
    """The inputs that raised on the card before C3 was repaired, once each:
    K1 at 16 query heads a KV head and hd 256 (B 2, nq 32, nkv 2, C 128) in
    its base, int8-cache and sideband modes, bf16 and f32; K2/K3 with f32
    activations and int8 weights (1e-4); and greedy `generate` of the tiny
    f32 config with int8 layer weights on the card against the CPU (1e-4)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlasaConfig
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain)
    from kalle_tpu_torch.ops.kernels.qmm import (fused_mlp, fused_mlp_plain, qmm,
                                                 qmm_plain)
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    L, B, nq, nkv, hd, C = 2, 2, 32, 2, 256, 128
    errs = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q = torch.randn(B, nq, hd, generator=g, device="cuda").to(dt)
        kt = torch.randn(L, B, nkv, hd, C, generator=g, device="cuda").to(dt)
        v = torch.randn(L, B, nkv, C, hd, generator=g, device="cuda").to(dt)
        mask = torch.rand(B, C, generator=g, device="cuda") > 0.3
        mask[:, 0] = True
        ks = kt.float().abs().amax(3, keepdim=True) / 127
        vs = v.float().abs().amax(4, keepdim=True) / 127
        kn, vn = (torch.randn(B, nkv, hd, generator=g, device="cuda").to(dt) for _ in range(2))
        modes = {"base": (kt, v, {}),
                 "int8": (torch.round(kt.float() / ks).to(torch.int8),
                          torch.round(v.float() / vs).to(torch.int8),
                          dict(k_scale=ks, v_scale=vs.transpose(-1, -2).contiguous())),
                 "sideband": (kt, v, dict(k_new=kn, v_new=vn, new_valid=torch.tensor(
                     [True, False], device="cuda")))}
        for mode, (kk, vv, kw) in modes.items():
            got = decode_attention_cached(q, kk, vv, 1, mask, **kw)
            ref = decode_attention_plain(q, kk, vv, 1, mask, **kw)
            _assert_close(f"decode_attention group 16 hd 256 {mode} {dt}", got, ref, tol, tol)
            errs[f"K1 {mode} {str(dt)[6:]}"] = _max_err(got, ref)
    x = torch.randn(9, 256, generator=g, device="cuda")
    w = torch.randn(256, 512, generator=g, device="cuda") * 0.05
    s = w.abs().amax(0) / 127
    wq = torch.round(w / s).to(torch.int8)
    _assert_close("qmm f32 x", qmm(x, wq, s), qmm_plain(x, wq, s), 1e-4, 1e-4)
    errs["K2 f32"] = _max_err(qmm(x, wq, s), qmm_plain(x, wq, s))
    mlp = [{"q": wq, "scale": s}, {"q": wq.flip(0).contiguous(), "scale": s},
           {"q": wq.t().contiguous(), "scale": s[:256].contiguous()}]
    got, ref = fused_mlp(x, *mlp), fused_mlp_plain(x, *mlp)
    _assert_close("fused_mlp f32 x", got, ref, 1e-4, 1e-4)
    errs["K3 f32"] = _max_err(got, ref)

    cfg = LlasaConfig.tiny()
    params = quantize_llama_params(llasa.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"))
    ids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = generate(tree_map(lambda t: t.to(dev), params), cfg, ids.to(dev),
                            mask.to(dev), max_frames=8, greedy=True)
    if not torch.equal(out["cpu"].n_frames, out["cuda"].n_frames.cpu()):
        raise AssertionError("tiny f32 int8 generate: n_frames differ between card and CPU")
    _assert_close("tiny f32 int8 generate", out["cuda"].means.cpu(), out["cpu"].means,
                  1e-4, 1e-4)
    errs["tiny f32 int8 generate"] = _max_err(out["cuda"].means.cpu(), out["cpu"].means)
    log("  C3 shapes on the card, max_abs_err: " + " ".join(
        f"{k} {v:.3g};" for k, v in errs.items()))


def phase_kernels():
    log("# phase 2: each kernel against its plain version, main-path shapes")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for check in (check_decode_attention, check_decode_attention_sideband, check_qmm,
                  check_fused_mlp, check_convnext, check_flash):
        r = check(g)
        rows.extend(r if isinstance(r, list) else [r])
        torch.cuda.empty_cache()
    check_c3(g)
    for r in rows:
        log_row(r)
    return rows


# --------------------------------------------------------------- phase 3 ----

def flagship():
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig

    llama = dataclasses.replace(LlamaConfig(), dtype="bfloat16", param_dtype="bfloat16")
    return LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=2048, head_variant="sigma")


def flagship_int8(g):
    """The flagship's params in bf16 with int8 layer weights, from `g`."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    params = llasa.init_params(flagship(), g, "cuda")
    return quantize_llama_params(tree_map(lambda t: t.to(torch.bfloat16), params))


def phase_slice(card: str):
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.ops.kernels import _build

    log("# phase 3: text -> 24 kHz wav, flagship width, batch 32")
    cfg = flagship()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = flagship_int8(g)
    codec = Codec.random_init("sigma", g, "cuda").astype(torch.bfloat16)
    ids = torch.randint(0, 128255, (BATCH, TEXT_LEN), generator=g, device="cuda")
    mask = torch.ones((BATCH, TEXT_LEN), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    log(f"  init + int8 quantization {time.perf_counter() - t0:.2f} s")

    def run(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        a = time.perf_counter()
        res = generate(params, cfg, ids, mask, gen, max_frames=MAX_FRAMES)
        torch.cuda.synchronize()
        b = time.perf_counter()
        audio = sigmavae.decode(codec.params, codec.cfg, res.samples.to(torch.bfloat16))
        torch.cuda.synchronize()
        return res, audio, b - a, time.perf_counter() - b

    res, audio, _, _ = run(1)  # warm-up
    es = generate(params, cfg, ids, mask, torch.Generator(device="cuda").manual_seed(99),
                  max_frames=MAX_FRAMES, end_kl_threshold=2.0)
    n_es = es.n_frames.cpu()
    if not ((n_es < MAX_FRAMES) & (n_es >= cfg.min_frames)).all():
        raise AssertionError(f"early-stop arm did not fire: {n_es[:4].tolist()}")
    log(f"  early-stop arm (threshold 2.0): n_frames {sorted(set(n_es.tolist()))}")

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gen_s = codec_s = 0.0
    steps = 0
    t0 = time.perf_counter()
    for i in range(ITERS):
        res, audio, a, b = run(2 + i)
        gen_s += a
        codec_s += b
        steps += int(res.n_frames.max()) + 1
    wall = (time.perf_counter() - t0) / ITERS
    launches = _build.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_frames = res.n_frames.cpu()
    hop = codec.samples_per_frame
    if tuple(audio.shape) != (BATCH, 1, MAX_FRAMES * hop) or not torch.isfinite(audio).all():
        raise AssertionError(f"bad audio {tuple(audio.shape)}")
    if not (n_frames == MAX_FRAMES - 1).all():
        raise AssertionError(f"sigma head stopped early: {n_frames[:4].tolist()}")
    L = cfg.llama.num_layers
    blocks = len(codec.cfg.strides) * codec.cfg.blocks_per_stage
    expect = {"decode_attention": L * steps, "qmm": 4 * L * steps,
              "fused_mlp": L * steps, "convnext_block": blocks * ITERS}
    log("kernels launches " + json.dumps(launches))
    for name, n in expect.items():
        if launches.get(name, 0) != n or n == 0:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, "
                                 f"the path implies {n}")
    audio_s = BATCH * (MAX_FRAMES - 1) / LATENT_HZ
    log(f"slice rtf {wall / audio_s:.6g} wall_s {wall:.4f} audio_s {audio_s:.2f} "
        f"generate_ms_per_step {gen_s / steps * 1e3:.4f} (prefill included) "
        f"codec_ms {codec_s / ITERS * 1e3:.3f} peak_mem_gb {peak_gb:.2f} card {card}")
    profile_once(run)
    return launches


def profile_once(run):
    """Device time by kernel over one more text -> wav run (after the counts
    were read), and the device's busy share of that run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, gen_s, codec_s = run(9)
    report_profile(prof, gen_s + codec_s, "one text -> wav run")


def phase_reference():
    """A small model whose shapes the kernels take, greedy, on the card
    (kernels) and on the CPU (the plain versions): latents and wav agree."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    log("# small-input check: card path vs the plain CPU path")
    llama = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    cfg = LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=256)
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = quantize_llama_params(tree_map(lambda t: t.to(torch.bfloat16), params))
    vcfg = sigmavae.SigmaVAEConfig(strides=(2, 4), channels=(64, 128))
    codec = Codec.random_init("sigma", torch.Generator().manual_seed(1), "cpu", cfg=vcfg)
    codec.astype(torch.bfloat16)
    ids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(2))
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    mask[2, :6] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        res = generate(p, cfg, ids.to(dev), mask.to(dev), max_frames=8, greedy=True)
        cp = tree_map(lambda t: t.to(dev), codec.params)
        out[dev] = (res, sigmavae.decode(cp, vcfg, res.means))
    (rc, wc), (rg, wg) = out["cpu"], out["cuda"]
    if not torch.equal(rc.n_frames, rg.n_frames.cpu()):
        raise AssertionError("n_frames differ between card and CPU")
    e_lat = _max_err(rg.means.cpu(), rc.means)
    e_wav = _max_err(wg.cpu(), wc)
    log(f"  latents max_abs_err {e_lat:.4g} wav max_abs_err {e_wav:.4g} (bf16, limit 5e-2)")
    if e_lat > 5e-2 or e_wav > 5e-2 or not torch.isfinite(wg).all():
        raise AssertionError("card path disagrees with the plain CPU path")


# --------------------------------------------------------------- phase 4 ----

def write_latents(root: str, n: int) -> str:
    """n synthetic sigma latents (1, frames, 64) .npy and their meta.jsonl;
    caption + frames fit the 512 bucket."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"lat{i}.npy")
        frames = int(rng.integers(300, 440))
        np.save(path, rng.normal(size=(1, frames, 64)).astype(np.float32))
        rows.append({"id": f"u{i}", "vae": path,
                     "caption": f"synthetic utterance {i} of the training smoke run"})
    meta = os.path.join(root, "meta.jsonl")
    with open(meta, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))
    return meta


def phase_train(card: str, root: str):
    from kalle_tpu_torch.bridge import tree_leaves
    from kalle_tpu_torch.core.config import (DataConfig, ExperimentConfig, LlamaConfig,
                                             LlasaConfig, TrainConfig)
    from kalle_tpu_torch.data.tokens import build_tokenizer
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.train.trainer import Trainer

    log(f"# phase 4: Trainer.fit at full width, batch {TRAIN_B} x {TRAIN_T}, "
        f"{TRAIN_A} microbatches a step, {TRAIN_STEPS} steps")
    meta = write_latents(root, TRAIN_B * TRAIN_A * 3)
    model = LlasaConfig(llama=LlamaConfig(use_flash_attention=True), latent_dim=64,
                        audio_proj_dim=2048, head_variant="sigma")
    exp = ExperimentConfig(
        project_name="chip_smoke_train", exp_dir=os.path.join(root, "exp"), model=model,
        train=TrainConfig(lr=5e-5, warmup_steps=2, total_steps=1000,
                          gradient_accumulation_steps=TRAIN_A, end_loss_weight=0.002,
                          log_interval=1, save_interval=10 ** 9, seed=0),
        data=DataConfig(meta_path=meta, batch_size=TRAIN_B, use_dynamic=False,
                        num_workers=1, prefetch_size=4, length_buckets=(TRAIN_T,),
                        max_length=TRAIN_T))
    tok = build_tokenizer()
    t0 = time.perf_counter()
    trainer = Trainer(exp, tok, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(trainer.state.params))
    log(f"  init {time.perf_counter() - t0:.2f} s, {n_params} parameters (f32 master)")
    before = [p.detach().clone() for p in tree_leaves(trainer.state.params)]

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(max_steps=TRAIN_STEPS, profile_steps=(TRAIN_STEPS - 1, TRAIN_STEPS - 1))
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches().items() if k.startswith("flash")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = trainer.history
    losses = [h["total_loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    moved = [bool((p.detach() != b).any()) for p, b in zip(tree_leaves(trainer.state.params),
                                                           before)]
    if not all(moved):
        raise AssertionError(f"{moved.count(False)} of {len(moved)} params did not move")
    del before
    L = model.llama.num_layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        expect = L * TRAIN_A * TRAIN_STEPS
        if launches.get(name, 0) != expect:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, the path "
                                 f"implies {expect}")
    log("kernels launches " + json.dumps(launches))
    step_ms = [1e3 / h["steps_per_s"] for h in hist]
    steady = sorted(step_ms[1:-1])  # not the first (warm-up) nor the profiled last
    ms = steady[len(steady) // 2]
    tokens = TRAIN_A * TRAIN_B * TRAIN_T
    log(f"  losses {[round(x, 5) for x in losses]}")
    log(f"train ms_per_step {ms:.2f} (median of steps 2..{TRAIN_STEPS - 1}; all "
        f"{[round(x, 1) for x in step_ms]}) tokens_per_s {tokens / ms * 1e3:.0f} "
        f"({tokens} tokens a step) model_flops_share "
        f"{6 * n_params * tokens / (ms / 1e3) / BF16_FLOP_PER_S:.4f} "
        f"peak_mem_gb {peak_gb:.2f} fit_s {fit_s:.1f} card {card}")
    log(f"  K5-K7 launches a step: " + json.dumps(
        {k: v / TRAIN_STEPS for k, v in launches.items()}))
    report_profile(trainer.profiler, trainer.profile_wall_s, "profiled step")

    # the final checkpoint restores into a fresh trainer (params and AdamW state)
    trainer.state.optimizer.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    again = Trainer(exp, tok, device="cuda")
    if again.start_step != TRAIN_STEPS:
        raise AssertionError(f"restored step {again.start_step}, saved {TRAIN_STEPS}")
    for a, b in zip(tree_leaves(again.state.params), tree_leaves(trainer.state.params)):
        if not torch.equal(a, b):
            raise AssertionError("a restored param differs from the trained one")
    sa, sb = again.state.optimizer.state_dict(), trainer.state.optimizer.state_dict()
    for i, st in sb["state"].items():
        if not all(torch.equal(v, sa["state"][i][k].to(v.device)) for k, v in st.items()):
            raise AssertionError("restored AdamW state differs")
    log(f"  checkpoint restored in {time.perf_counter() - t0:.1f} s: params and AdamW "
        "state equal")
    del again, trainer
    torch.cuda.empty_cache()
    return launches


def report_profile(prof, wall_s: float, what: str) -> None:
    """Device time by kernel and the busy share of `wall_s`; user
    annotations (ranges such as Optimizer.step, which the profiler also
    lists with device time) are left out."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log(f"  profile of {what}: the profiler saw no device time")
        return
    log(f"  profile of {what} (profiler on): wall_ms {wall_s * 1e3:.1f} device_busy_ms "
        f"{busy_us / 1e3:.1f} busy_share {busy_us / 1e6 / wall_s:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} calls "
            f"{e.self_device_time_total / busy_us:6.3f}  {e.key[:90]}")


def phase_train_reference():
    """One train_step of a small model whose shapes the kernels take, on the
    card (K5-K7) and on the CPU (their plain versions), from the same
    weights and batch: loss and grads agree within bf16 tolerance."""
    from kalle_tpu_torch.bridge import tree_leaves, tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig, TrainConfig
    from kalle_tpu_torch.data.collate import Item, collate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.train.step import make_train_state, train_step

    log("# phase 4 small-input check: train_step on the card vs the plain CPU path")
    llama = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    cfg = LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=256,
                      head_variant="stableaudio")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    items = []
    for n_ids, n_frames in ((12, 180), (30, 226), (7, 100), (20, 200)):
        dist = np.concatenate([rng.normal(size=(n_frames, 64)),
                               rng.uniform(0.5, 1.5, size=(n_frames, 64))], -1)
        items.append(Item(input_ids=rng.integers(0, 300, n_ids).astype(np.int32),
                          audio_latents=rng.normal(size=(n_frames, 64)).astype(np.float32),
                          audio_distribution=dist.astype(np.float32)))
    np_batch = collate(items, 0, buckets=(256,))
    out = {}
    for dev in ("cpu", "cuda"):
        state = make_train_state(tree_map(lambda t: t.clone().to(dev), params), tcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()
                 if isinstance(v, np.ndarray)}
        batch["input_ids"] = batch["input_ids"].long()
        m = train_step(state, cfg, tcfg, batch, use_flash=True)
        out[dev] = (float(m["total_loss"]), [p.grad.cpu() for p in tree_leaves(state.params)])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    g_err = max(_rel_err(a, b) for a, b in zip(gg, gc))
    log(f"  loss cpu {lc:.6f} card {lg:.6f}; grads max relative error {g_err:.4g} "
        "(bf16, limits 1e-2 loss, 5e-2 grads)")
    if abs(lg - lc) > 1e-2 * abs(lc) or g_err > 5e-2:
        raise AssertionError("the card's train_step disagrees with the plain CPU path")


# --------------------------------------------------------------- phase 5 ----

def serve_texts(n: int, rng) -> list:
    """n texts whose prompts are 20..120 byte-tokenizer ids (the text's
    bytes and the two speech markers)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz  "))
    return ["".join(rng.choice(letters, size=int(rng.integers(18, 119)))) for _ in range(n)]


def phase_serve(card: str):
    from kalle_tpu_torch.data.tokens import build_prompt_ids, build_tokenizer
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
    from kalle_tpu_torch.ops.kernels import _build

    log(f"# phase 5: continuous-batching serving at full width, {SERVE_REQS} requests, "
        f"{SERVE_FRAMES} frames each, all arriving at t=0")
    cfg = flagship()
    params = flagship_int8(torch.Generator(device="cuda").manual_seed(0))
    tok = build_tokenizer()
    prompts = [np.asarray(build_prompt_ids(tok, t))
               for t in serve_texts(SERVE_REQS, np.random.default_rng(0))]
    log(f"  prompt ids: {min(map(len, prompts))}..{max(map(len, prompts))}; cache "
        f"{SERVE_CACHE} slots")
    L = cfg.llama.num_layers
    serve_launches = None
    for B in (32, 8):
        cb = ContinuousBatcher(params, cfg, batch_size=B, max_frames=SERVE_FRAMES,
                               prompt_buckets=SERVE_BUCKETS, seed=0)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        comps = cb.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launches()
        if sorted(c.index for c in comps) != list(range(SERVE_REQS)):
            raise AssertionError("the batcher lost or repeated a request")
        for c in comps:
            if (c.n_frames != SERVE_FRAMES - 1 or c.means.shape != (SERVE_FRAMES - 1, 64)
                    or not np.isfinite(c.samples).all()):
                raise AssertionError(f"request {c.index}: {c.n_frames} frames, "
                                     f"shape {c.samples.shape}")
        steps = cb.step_count
        expect = {"decode_attention_sideband": L * steps, "qmm": 4 * L * steps,
                  "fused_mlp": L * steps, "decode_attention": 0}
        for name, n in expect.items():
            if launches.get(name, 0) != n:
                raise AssertionError(f"serve batch {B}: {name} launched "
                                     f"{launches.get(name, 0)} times, the path implies {n}")
        frames = sum(c.n_frames for c in comps)
        log(f"serve batch {B} requests_per_s {SERVE_REQS / wall:.4f} frames_per_s "
            f"{frames / wall:.1f} ms_per_step {wall / steps * 1e3:.4f} (admission and prefill "
            f"included) decode_steps {steps} wall_s {wall:.3f} card {card}")
        log(f"kernels launches (batch {B}) " + json.dumps(launches))
        if B == 32:
            serve_launches = launches
            with_profile(lambda: cb.run(prompts[:B]), f"a batch-{B} serve of {B} requests")
        del cb
        torch.cuda.empty_cache()
    serve_cross_check(params, prompts[:4])
    serve_http_check(params, tok, card)
    return serve_launches


def with_profile(fn, what: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, what)


def serve_cross_check(params_int8, prompts):
    """Greedy completions of the batcher against `generate` for the same 4
    prompts over their first 16 frames, on the card. `generate` gets each
    prompt as the batcher prefills it (left-padded to its bucket, with the
    batcher's cache length), so frame 0 is the same computation; from frame
    2 on every decode step reads cache columns that earlier steps wrote.
    In f32 (dense weights, f32 cache: maybe_matmul and K1's f32 sideband)
    the two are the same arithmetic in another order, so all 16 frames must
    agree to 1e-3 of the largest |mean|. In bf16 with int8 weights (the
    serving path) each frame is fed back through 16 layers of a random
    full-width model, which amplifies bf16 rounding about 1.6x a frame, so a
    rerun of `generate` itself (K3's atomics reorder its sums) drifts too.
    There frames 0-7 (six decode steps that read written columns) must each
    stay within max(2e-2, 4 x the rerun's largest departure up to that
    frame); the whole curves are printed."""
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
    from kalle_tpu_torch.models.lm import llasa

    n, gated = 16, 8

    def generated(cfg, params, cache_len):
        out = []
        for ids in prompts:
            bk = min(b for b in SERVE_BUCKETS if b >= len(ids))
            t = torch.zeros((1, bk), dtype=torch.int64, device="cuda")
            t[0, bk - len(ids):] = torch.as_tensor(ids, device="cuda")
            m = torch.zeros_like(t)
            m[0, bk - len(ids):] = 1
            out.append(generate(params, cfg, t, m, max_frames=n + 1, cache_len=cache_len,
                                greedy=True).means[0, :n].float().cpu().numpy())
        return out

    def curve(got, ref):
        """Per frame, the largest |difference| over the prompts, over the
        largest |mean| of the reference."""
        return np.max([np.abs(a - b).max(axis=1) / np.abs(b).max()
                       for a, b in zip(got, ref)], axis=0)

    f32 = LlasaConfig(llama=dataclasses.replace(LlamaConfig(), dtype="float32"),
                      latent_dim=64, audio_proj_dim=2048, head_variant="sigma")
    f32_params = llasa.init_params(f32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    failed = []
    for what, cfg, params in (("bf16 int8", flagship(), params_int8),
                              ("f32", f32, f32_params)):
        cb = ContinuousBatcher(params, cfg, batch_size=4, max_frames=n + 1,
                               prompt_buckets=SERVE_BUCKETS, greedy=True)
        comps = {c.index: c.means for c in cb.run(prompts)}
        got = [comps[i] for i in range(len(prompts))]
        ref = generated(cfg, params, cb.state.k.shape[-1])
        if any(a.shape != (n, 64) for a in got):
            raise AssertionError(f"cross-check {what}: shapes {[a.shape for a in got]}")
        err = curve(got, ref)
        rerun = curve(generated(cfg, params, cb.state.k.shape[-1]), ref)
        if what == "f32":
            bar = np.full(n, 1e-3)
        else:
            bar = np.maximum(2e-2, 4 * np.maximum.accumulate(rerun))
            bar[gated:] = np.inf
        log(f"  serve cross-check {what}: batcher vs generate, 4 prompts, per frame max "
            f"|diff| / max |generate|: {' '.join(f'{x:.2e}' for x in err)}")
        log(f"    generate vs its rerun: {' '.join(f'{x:.2e}' for x in rerun)}")
        log(f"    tolerance per frame: {' '.join(f'{x:.2e}' for x in bar)}; worst share "
            f"of it {np.max(err / bar):.4g}")
        if not (err <= bar).all():
            failed.append(what)
        del cb
    del f32_params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"cross-check {failed}: the batcher disagrees with generate")


def serve_http_check(params, tok, card: str):
    """serve_http on port 0 with the real BatcherService (batch 8, chunks of
    25 frames) and the bf16 SigmaVAE: eight concurrent /tts clients."""
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.serve.http import make_stream_fn, serve_http
    from kalle_tpu_torch.serve.web import wav_chunk_header

    n_clients = 8
    codec = Codec.random_init("sigma", torch.Generator(device="cuda").manual_seed(1),
                              "cuda").astype(torch.bfloat16)
    stream = make_stream_fn(params, flagship(), tok, codec, chunk_frames=25,
                            max_frames=SERVE_FRAMES, batch_size=8)
    srv = serve_http(stream, sample_rate=codec.sample_rate, host="127.0.0.1", port=0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/tts?text="
    texts = serve_texts(n_clients, np.random.default_rng(1))
    hdr = wav_chunk_header(codec.sample_rate)
    results, errors = {}, []

    def client(i):
        try:
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + urllib.parse.quote(texts[i]),
                                        timeout=600) as r:
                head = r.read(len(hdr))
                first = r.read(2)  # the first PCM sample: time to first audio
                ttfa = time.perf_counter() - t0
                body = first + r.read()
            results[i] = (head, body, ttfa, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — reported below, and the phase fails
            errors.append(f"client {i}: {e!r}")

    try:
        _build.reset_launches()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        launches = _build.launches()
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"http clients failed: {errors}")
    finally:
        srv.shutdown()
        srv.server_close()
        stream.service.close()
        server.join(timeout=30)
    want = (SERVE_FRAMES - 1) * codec.samples_per_frame * 2
    for i, (head, body, _, _) in sorted(results.items()):
        if head != hdr or len(body) != want:
            raise AssertionError(f"http client {i}: header ok {head == hdr}, "
                                 f"{len(body)} PCM bytes, want {want}")
    for name in ("decode_attention_sideband", "qmm", "fused_mlp", "convnext_block"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"http serving did not launch {name}")
    ttfa = sorted(r[2] for r in results.values())
    total = sorted(r[3] for r in results.values())
    log(f"http {n_clients} concurrent /tts streams, each {want} PCM bytes: ttfa_s "
        f"{[round(x, 4) for x in ttfa]} total_s {[round(x, 4) for x in total]} "
        f"decode_steps {stream.service.cb.step_count} card {card}")
    log("kernels launches (http) " + json.dumps(launches))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 on the card is compared at full precision: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    card = card_line()
    rows = phase_kernels()
    launches = phase_slice(card)
    phase_reference()
    with tempfile.TemporaryDirectory() as root:
        launches.update(phase_train(card, root))
    phase_train_reference()
    launches["decode_attention_sideband"] = phase_serve(card)["decode_attention_sideband"]
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
        r["route"] = "cuda"
        r.pop("note", None)
    log(f"total_s {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
