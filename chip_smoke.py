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
     versions): loss and grads agree.

Phase 2 also holds K5-K7 (flash attention forward, dq, dk/dv) against
their plain versions at the flagship training shape (b 8, t 512, 32/8
heads, hd 64, bf16; ragged pads, a left-padded row, a row with no valid
key). Launch counts: K1-K4 from phase 3's run, K5-K7 from phase 4's.

Prints a `kernels` JSON line, the card line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Needs a CUDA card, nvcc, and nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
BATCH, TEXT_LEN, MAX_FRAMES, LATENT_HZ = 32, 32, 128, 7.5
ITERS = 3
# phase 4: batch rows, bucket length, microbatches a step, optimizer steps
TRAIN_B, TRAIN_T, TRAIN_A, TRAIN_STEPS = 8, 512, 2, 10


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
    layers = iter(range(10 ** 9))

    def each_layer(fn):
        def run():
            i = next(layers) % L
            return fn(i)
        return run

    kern = cuda_ms(each_layer(lambda i: decode_attention_cached(q[i], kt, v, i, mask)), 64)
    plain = cuda_ms(each_layer(lambda i: decode_attention_plain(q[i], kt, v, i, mask)), 16)
    lib_ms = None
    try:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        am = mask[:, None, None, :]
        lib_ms = cuda_ms(each_layer(lambda i: sdpa(
            q[i][:, :, None], kt[i].transpose(-1, -2), v[i], attn_mask=am,
            enable_gqa=True)), 64)
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


def _int8_layers(g, L, k, n):
    w = torch.randn(L, k, n, generator=g, device="cuda") * 0.02
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127
    return torch.round(w / scale[:, None]).to(torch.int8), scale


def check_qmm(g):
    from kalle_tpu_torch.ops.kernels.qmm import qmm, qmm_plain

    L, M, H = 16, BATCH, 2048
    shapes = {"wq": (H, 2048), "wk": (H, 512), "wv": (H, 512), "wo": (2048, H)}
    ws = {k: _int8_layers(g, L, *s) for k, s in shapes.items()}
    x = torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)
    err = 0.0
    for name, (q, s) in ws.items():
        got, ref = qmm(x, q[5], s[5]), qmm_plain(x, q[5], s[5])
        rel = _rel_err(got, ref)
        if rel > 1e-2:
            raise AssertionError(f"qmm {name}: relative error {rel:.4g} > 1e-2")
        err = max(err, _max_err(got, ref))
    deq = {k: (q.float() * s[:, None]).to(torch.bfloat16) for k, (q, s) in ws.items()}
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
    nbytes = sum(k * n + n * 4 + M * k * 2 + M * n * 2 for k, n in shapes.values())
    flops = sum(2 * M * k * n for k, n in shapes.values())
    return dict(name="qmm", source="kalle_tpu_torch/csrc/qmm.cu",
                replaces="kalle_tpu/ops/pallas/qmm.py:74", max_abs_err=err,
                ms=kern, plain_ms=plain, library_ms=lib, work=(nbytes, flops),
                note="one layer's wq+wk+wv+wo, M=32, int8")


def check_fused_mlp(g):
    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp, fused_mlp_plain

    L, M, H, F = 16, BATCH, 2048, 8192
    wg, wu, wd = (_int8_layers(g, L, *s) for s in ((H, F), (H, F), (F, H)))
    x = torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)

    def layer(i):
        return [{"q": q[i], "scale": s[i]} for q, s in (wg, wu, wd)]

    got, ref = fused_mlp(x, *layer(5)), fused_mlp_plain(x, *layer(5))
    rel = _rel_err(got, ref)
    if rel > 1e-2:
        raise AssertionError(f"fused_mlp: relative error {rel:.4g} > 1e-2")
    li = iter(range(10 ** 9))
    kern = cuda_ms(lambda: fused_mlp(x, *layer(next(li) % L)), 64)
    plain = cuda_ms(lambda: fused_mlp_plain(x, *layer(next(li) % L)), 16)
    nbytes = 3 * H * F + (2 * F + H) * 4 + 2 * M * H * 2
    return dict(name="fused_mlp", source="kalle_tpu_torch/csrc/qmm.cu",
                replaces="kalle_tpu/ops/pallas/qmm.py:151", max_abs_err=_max_err(got, ref),
                ms=kern, plain_ms=plain, library_ms=None,
                work=(nbytes, 3 * 2 * M * H * F))


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
    return rows


def phase_kernels():
    log("# phase 2: each kernel against its plain version, main-path shapes")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for check in (check_decode_attention, check_qmm, check_fused_mlp, check_convnext,
                  check_flash):
        r = check(g)
        rows.extend(r if isinstance(r, list) else [r])
        torch.cuda.empty_cache()
    for r in rows:
        nbytes, flops = r.pop("work")
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
        log(f"  {r['name']}: kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"library_ms {r['library_ms']} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) max_abs_err {r['max_abs_err']:.4g} {r.get('note', '')}")
    return rows


# --------------------------------------------------------------- phase 3 ----

def flagship():
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig

    llama = dataclasses.replace(LlamaConfig(), dtype="bfloat16", param_dtype="bfloat16")
    return LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=2048, head_variant="sigma")


def phase_slice(card: str):
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    log("# phase 3: text -> 24 kHz wav, flagship width, batch 32")
    cfg = flagship()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = llasa.init_params(cfg, g, "cuda")
    params = quantize_llama_params(tree_map(lambda t: t.to(torch.bfloat16), params))
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
    launches = dict(_build.LAUNCHES)
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
    launches = {k: v for k, v in _build.LAUNCHES.items() if k.startswith("flash")}
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
