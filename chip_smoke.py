"""Chip smoke test of the PyTorch/CUDA port (kalle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):
  1. build the hand-written kernels from csrc/ (one nvcc per source, all at
     once), print each kernel's registers and spills from ptxas (failing
     if K6's or K7's bf16 instance spills at hd 64), the toolchain and the
     card (nvidia-smi name, power limit);
  2. hold every kernel against its plain PyTorch version on the same inputs
     at the shapes the main path gives it, and time kernel, plain version
     and, where one exists, the single PyTorch call that computes the same
     function (a captured CUDA graph's replay, timed with CUDA events);
  3. drive the main path — text -> latents -> 24 kHz wav — at bench.py's
     shape: the 1B Llama-3.2-shape Llasa (random weights from a seeded
     torch.Generator, bf16, int8 layer weights, sigma head, 64-d latents),
     batch 32, 32 text ids, 128 frames, bf16 SigmaVAE decode; the early-stop
     arm; then 2 timed iterations with every kernel's launch count read and
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
     departure of `generate` through K3's plain version with the FFN
     columns reversed from it as it is: the same sums in another order),
     the rest printed; the batcher with a planted one-slot fault must fail
     that bar in both dtypes); then serve_http
     on port 0 with the real BatcherService (batch 8, chunks of 25
     frames) and the bf16 SigmaVAE: eight concurrent GET /tts clients,
     each body the wav header and
     exactly (128 - 1) * 3200 * 2 PCM bytes, with time to first audio and
     total seconds a request;
  6. InferTools at full width (phase 3's int8 Llasa, the default bf16
     SigmaVAE): (a) infer_jsonl over 8 rows (texts of 20-120 byte ids,
     sigma latents of 40-120 frames) at batch 8 and 128 frames, twice,
     checking every caption, copysyn wav (T_i * 3200 samples) and gen wav
     (127 * 3200) at 24 kHz, with wall seconds and RTF; (b) a 4 s 16 kHz
     int16 reference through the demo's synthesize fn: resampled, encoded
     in bf16 (K4 in the encoder's 10 blocks; encode ms), a 30-frame voice
     prompt, 128 frames (wall seconds); (c) a small f32 model with int8
     layer weights and a small f32 codec on the card against the CPU:
     encode, greedy generate with the encoded prompt and an embed bias,
     decode (1e-3); (d) `python -m kalle_tpu_torch.infer.cli` in its own
     process on the card, a tiny int8 model, --limit 2 -m 8. Every step
     checks K1-K4's launch counts exactly;
  7. closing the port at full width: (a) phase 3's weights as an f32 Llasa
     exported to a reference-layout .pt and read back onto the card, every
     leaf bit-equal; (f) prompt_fit on phase 6's encoded prompt, 3 steps at
     lr 1e-6 (K5-K7 exactly 16 a step, s a step, peak memory); (b) a
     Trainer warm-started from the .pt at phase 4's shape, 4 steps, a
     checkpoint every 2 (2 kept), the eval-audio hook on a bf16 SigmaVAE:
     params before step 1 equal the file's, steps 2 and 4 kept,
     restore(step=2) equals the state saved then, every hook wav at its
     length, finite, 24 kHz, seconds blocked in save beside the writer
     thread's; (c) generate at bench shape with the fused decode layout
     beside the unfused one (ms a step; K2 2·16·128, K3's fused mode and
     K1 16·128 launches), K3's fused mode bit-identical to the unfused K3
     at M 8/32/72 on the flagship's layer, K2 on wqkv against three
     launches, a small f32 model's fused frames against its unfused ones
     (1e-3); (d) the batcher on the fused params, 16 requests at batch 8,
     and a small f32 fused batcher against its unfused one (1e-3); (e) int4
     (group 128): 16 frames at batch 32 beside int8 (the plain group-wise
     route), a small f32 int4 model card vs CPU (1e-3).
  8. the other codecs, CFG and streaming at full width (phase 3's int8
     backbone; heads, codecs and conditioning from a seeded generator): (a)
     InferTools.synthesize_batch of 8 texts (20-120 byte ids) at 128
     frames through the default Oobleck (bf16, 44.1 kHz stereo, a stableaudio
     head): every wav finite, |x| <= 1, n_frames x 2048 samples (wall, RTF,
     codec ms), and a 4 s clip through encode_audio (the encoder's frame
     formula; ms); (b) the same through MelVAEConfig() (bf16, 16 kHz, a
     melvae head of latent 512) with flow_reverse, after the flow's forward
     then reverse on the card in f32 (1e-4); (c) cfg_generate v1 and v2 on
     (a)'s model at batch 1, 32 text ids, 128 frames, threshold 0 (ms a
     step); (d) stream_generate at batch 8, 32 text ids, 128 steps at
     melvae_dim2048_tts_sft's shape (latent 1024): a speaker frame from a
     4 s 16 kHz reference (mel, 200 frames, ECAPA at EcapaConfig(), the
     speaker VAE's draw), warm-up latents from a frame of silence through a
     latent-1024 mel-VAE, then the decode (ms a step, ECAPA ms); (e)
     stream_spkvae_forward and its gradient at phase 4's shape (f32 params,
     bf16, flash: K5-K7 16 launches each, finite loss and grads) and one
     MRTE forward at MRTEConfig(); (f) small f32 models on the card against
     the CPU (1e-3): a tiny Oobleck and MelVAEConfig.tiny() (encode, decode,
     both flow directions), a tiny ECAPA and MRTE, cfg_generate v1/v2 and
     stream_generate of a small int8 model with the same injected noise.
     (a)-(d) check K1-K3's launches exactly (K4 none); after the counted
     runs, one profiled codec decode each in (a) and (b), 32 frames of
     (c) v1 and 32 steps of (d) print device time by kernel and busy share.
  9. codec training and evaluation: (a) the codec trainer in f32 at each
     codec's default config on rendered synthetic speech (sigma
     SigmaVAEConfig(), DiscriminatorConfig(), LSGAN, batch 4 x 48,000
     samples, an EMA and a latent mask of 0.1; melvae MelVAEConfig(), LSGAN,
     batch 4 x 40,960, its encoder frozen on the first step; oobleck
     OobleckConfig(), DiscriminatorConfig.encodec_stereo(), hinge,
     LossWeights.oobleck_default(), batch 2 x 65,536 stereo): one recon-only
     generator step, then 4 with the GAN on, the discriminator on odd
     steps; checks finite losses, that both sides' weights moved, the EMA
     differs, the frozen encoder did not move, no kernel launched (K4
     included: autograd records the blocks), and that a CodecTrainState
     checkpoint restores bit-equal; prints ms a generator and a
     discriminator step, peak memory and one profiled step; (b) one
     generator and one discriminator step of each kind's small f32 config
     on the card and the CPU, and in float64 on the CPU, the same injected
     draws, sigma and oobleck against rendered speech (losses 1e-4
     relative; per leaf, the card's gradient as near the float64 one as
     twice the CPU's f32 error plus 1e-5 of the leaf's largest; every
     element on the AdamW rule within 1e-2·lr; params 1e-2·lr where both
     f32 gradients have the float64 one's sign; at most 5% below that);
     (c) flow_space_kl through a latent-1024
     mel-VAE flow at batch 8 x 128 (finite, the gradient reaches
     pre_log_scale only, as in JAX; ms); (d) the CTC ASR at CTCConfig() and
     the speaker embedder at SpeakerTrainConfig(), 100 steps each (render
     seconds, ms a step, first and last loss, which must fall), the
     speaker margin, then a fresh infer_jsonl of 8 rows at 128 frames
     scored by wer_pipeline (gen and copysyn arms, the CTC transcriber)
     and speaker_similarity (the trained ECAPA and the spectral embedder):
     every file written, finite values, K1-K4's launches exact; (e)
     `kalle_tpu_torch.train.codec_demo --size small --steps 4 --gan` in
     process, its last line the JAX tool's keys.
 10. parallelism: (a) the mesh paths at world size 1 over NCCL (a
     one-rank group through a file store): `Trainer.fit` of phase 4's
     model at depth 4 for 8 steps with dp=-1, tp=1, pp=1 and then with
     fsdp, losses and weights bit-identical to the same run with no
     process group, ms a step the median of steps 2-8; `ContinuousBatcher(mesh=make_mesh(dp=1, tp=1))` over
     16 greedy requests at batch 8 (64 frames) bit-identical to
     mesh=None; ms a step of each; launches exact; (b) `parallel/tp_probe`
     at tp 2, 4 and 8: each rank's decode layer halves at full width
     (int8, batch 32, cache 384; K1 at 8/tp KV heads, K2 on the column
     and row shards and the fused wqkv, K3 on F/tp and its fused mode)
     and one training attention forward and backward through K5-K7 at
     32/tp heads, every kernel against its plain version (phase 2's bf16
     tolerances), the launches exact, and the partials summed over the
     ranks against the unsharded layer (2e-2 of the largest magnitude).
 11. the tools (kalle_tpu_torch/tools), each step's launch counts read and
     checked: (a) latency_bench at full width (the flagship in bf16, the
     bf16 SigmaVAE): TTFA p50 / p95 at batch 1 and 8 (chunks of 8 frames,
     then the codec) and RTF with the codec over 128 frames; --poisson at
     batch 8, 32 requests at 2 and 4 req/s (TTFA and end-to-end p50 /
     p95); --interleave at batch 1; (b) http_bench: 16 requests at 2
     req/s, 64 frames, chunks of 8, no client error and every body the
     header and (64 - 1) * 3200 * 2 PCM bytes; (c) `python -m
     kalle_tpu_torch.tools.run_experiment` in its own process at the JAX
     tiny WER run's arguments (--tiny --steps 1500 --rows 6 --seconds 0.5,
     the WER arm on), its nine gates printed beside that run's: the six
     that hold the machinery must pass (loss drop, latent gate, checkpoint
     round trip, wavs written, copysyn WER, speaker margin), the three that
     grade what the tiny LM learned (prompt clone, end detection,
     generated WER) are reported; K1 once a layer a step of generate's
     loop and K5-K7 once a layer a training step, exactly; then a witness
     on the chain's own trained LM and rows, the card against the CPU: the
     loss and gradients through K5-K7, 32 greedy frames through K1, the
     end-detection arm trained from one init on both, and the latent gate
     decoded on the CPU; (d) serve_batch in its own process, a
     tiny int8 model, 4 rows at batch 2, -m 8: each wav 7 frames of the
     tiny random codec (hop 8), written in completion order; (e) decode_microbench --int8 at batch 32
     (weights, step, step_nokv, gen), serve_profile at batch 8, 16 and 32
     (int8) and train_microbench at b8 x t512 with flash and remat none,
     full and dots (ms a step, MFU, peak memory); (f) the native host
     library: align_tokens against the Python alignment on 200 seeded
     pairs and load_npy_batch of 64 phase-4-sized latent files against
     np.load, with seconds.

Phase 1 fails if a bf16 instance of K1, K3 or K4 (or K6/K7 at hd 64) spills.
Phase 2 holds K3 at M 8, 32 and 72 (1e-2 relative) and K4 at the five
decoder widths and at the encoder's five shapes of a 4 s voice prompt
(batch 1; 2e-2 abs + rel), each rerun bit-identical, K3 beside a
composed three-call yardstick and K4 shape by shape against its bound;
the profiles of phases 3 and 5 print K3's and K4's device time.
Phase 2 holds K1 at the main path's last decode step (rerun bit-identical),
times it with every column valid against its bound over all of C, and
holds its tensor-core kernel on the edge cases (a masked leading tile, a
valid range inside one block's share, no valid key, left-pad holes, only
the new column counted) at batch 1, 8 and 32 in both modes, each rerun
bit-identical.
Phase 2 also holds K5-K7 (flash attention forward, dq, dk/dv) against
their plain versions at the flagship training shape (b 8, t 512, 32/8
heads, hd 64, bf16; ragged pads, a left-padded row, a row with no valid
key) and at hd 128 (b 4, 16/4 heads), with K6's and K7's dead rows
exactly 0 and their reruns bit-identical, beside SDPA's forward and its
backward alone (the yardstick of K6 + K7), K1's sideband mode at phase 5's
shapes (batch 8 and 32, cache 384, ragged rows, some rows' new column not
counted; reruns bit-identical), K2 at M 8, 32 and 72 (the kernels line
keeps M 32), and, once each, the inputs that raised
before C3's repair: K1 at 16 query heads a KV head and hd 256 in all three
modes, K2/K3 with f32 activations, and the tiny f32 config with int8
weights decoding on the card against the CPU. Phase 2 also holds the
fused decode layout's K2 on wq|wk|wv (2048, 3072) in one launch and K3's
fused mode (wg | wu as one (2048, 16384) matrix) at M 8, 32 and 72: K3's
fused mode bit-identical to the unfused K3, K2's within bf16 tolerance of
three launches, both reruns bit-identical, K2 beside `torch.matmul`. Launch counts: K1-K3 from
phase 3's run, K4 from phase 3's and phase 6's counted runs, K5-K7 from
phase 4's, K1's sideband from phase 5's batch-32 run, each plus phase 7's
counted runs and phase 8's ((a)-(d) for K1-K3, (e) for K5-K7), phase 9's
scoring run (K1-K4), phase 10(a)'s mesh runs (K1's sideband, K2, K3,
K5-K7) and phase 11's counted runs (every kernel); the fused layout's K2
and K3 rows from phase 7's fused generate runs.

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
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

from kalle_tpu_torch.core.config import flagship_cfg

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
BATCH, TEXT_LEN, MAX_FRAMES, LATENT_HZ = 32, 32, 128, 7.5
ITERS = 2  # timed runs: phase 3's text -> wav, phase 6's encode
# phase 4: batch rows, bucket length, microbatches a step, optimizer steps
TRAIN_B, TRAIN_T, TRAIN_A, TRAIN_STEPS = 8, 512, 2, 10
# phase 5: requests, frames a request, the batcher's prompt buckets and its
# cache length (the largest bucket plus max_frames + 1, rounded up to 128)
SERVE_REQS, SERVE_FRAMES, SERVE_BUCKETS = 64, 128, (16, 32, 64, 128)
SERVE_CACHE = -(-(SERVE_BUCKETS[-1] + SERVE_FRAMES + 1) // 128) * 128
# phase 6: jsonl rows, frames a generate call, the voice prompt's seconds and rate
INFER_ROWS, INFER_FRAMES, PROMPT_S, PROMPT_SR = 8, 128, 4, 16000


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

def ptxas_report(text: str):
    """(kernel, registers, stack and spill line) for each entry function in
    nvcc's -Xptxas -v log, names demangled by c++filt where there is one."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), spill])
            name, spill = None, ""
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(r[0] for r in out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = [r[0] for r in out]
    for r, p in zip(out, plain):
        p = p.replace("(anonymous namespace)::", "").removeprefix("void ")
        r[0] = p.split("(")[0]
    return out


# kernels that must not spill: K6/K7 bf16 at hd 64, K3's bf16 instances
# (int8 and bf16 weights, 8..64-row tiles) and its cluster sum, K4's
# tensor-core instances, K1's tensor-core instances (tc::decode_mma)
# (names demangled by c++filt, or mangled where it is missing)
SPILL_FREE = (r"flash_d(q|kv)_mma(<64>|ILi64E)|k3::(mlp|sum)_kernel|k310(mlp|sum)_kernel"
              r"|convnext_tc_kernel(<|ILi)|decode_mma")


def phase_build():
    from kalle_tpu_torch.ops.kernels import _build

    log("# phase 1: build and environment")
    t0 = time.perf_counter()
    per = _build.build()
    log(f"build_s {time.perf_counter() - t0:.2f} per_source "
        + json.dumps({k: round(v, 2) for k, v in per.items()}))
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        for name, regs, spill in ptxas_report(lib.read_text()):
            log(f"  ptxas {lib.stem.split('-')[0]} {name}: {regs} registers, {spill}")
            # K6's and K7's bf16 instances at the training head dim, and K1's,
            # K3's and K4's bf16 tensor-core instances, must not spill
            if (re.search(SPILL_FREE, name)
                    and "0 bytes spill stores, 0 bytes spill loads" not in spill):
                raise AssertionError(f"{name} spills registers: {spill}")
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
    """K1 at the main path's last decode step (batch 32, cache 256, 16
    layers): against its plain version, rerun bit-identical, timed beside
    the plain version and SDPA; the int8-cache instance (the first port's
    kernel); the same step with every column valid, timed against its
    bound over all of C (the design's gain apart from the skip's); and the
    tensor-core kernel on the edge cases at batch 1, 8 and 32."""
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain, decode_attention_plan)

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
    if not torch.equal(got, decode_attention_cached(q[7], kt, v, 7, mask)):
        raise AssertionError("decode_attention: a rerun is not bit-identical")
    err = _max_err(got, ref)
    plan = decode_attention_plan(B, nkv, nq // nkv, hd, C)

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
    del kq, vq, ks, vs

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

    # every column valid: the bound counts all of C
    full = torch.ones_like(mask)
    _assert_close("decode_attention fully valid", decode_attention_cached(q[7], kt, v, 7, full),
                  decode_attention_plain(q[7], kt, v, 7, full), 2e-2, 2e-2)
    full_ms = cuda_ms(each_layer(lambda i: decode_attention_cached(q[i], kt, v, i, full), L), 64)
    fb_ms, fb_by = bound(B * C * nkv * hd * 2 * 2 + 2 * B * nq * hd * 2 + B * C,
                         4 * B * C * nq * hd)
    log(f"  decode_attention fully valid B={B} C={C}: kernel_ms {full_ms:.4f} bound_ms "
        f"{fb_ms:.4f} ({fb_by}) cluster {plan['cluster']} stages {plan['stages']}")
    del q, kt, v
    torch.cuda.empty_cache()
    check_decode_attention_edges()
    return dict(name="decode_attention", source="kalle_tpu_torch/csrc/decode_attention.cu",
                replaces="kalle_tpu/ops/pallas/decode_attention.py:320",
                max_abs_err=err, ms=kern, plain_ms=plain, library_ms=lib_ms,
                work=(nbytes, flops),
                note=f"cluster {plan['cluster']}, stages {plan['stages']}, rerun bit-identical")


def check_decode_attention_edges():
    """K1's tensor-core kernel at batch 1, 8 and 32 (2 layers, cache 256,
    32 query / 8 KV heads, hd 64), base and sideband modes, on rows
    cycling through `decode_probe.edge_case_mask`'s cases (a masked
    leading tile, a valid range inside one block's share, no valid key,
    left-pad holes, every column valid, only the new column counted):
    against the plain version (2e-2 abs + 2e-2 rel), reruns bit-identical.
    Its inputs come from a generator of its own, so the checks after it
    draw what they drew before it existed."""
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain, decode_attention_plan)
    from kalle_tpu_torch.ops.kernels.decode_probe import edge_case_mask

    L, C, nq, nkv, hd = 2, 256, 32, 8, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    for B in (1, 8, 32):
        q = torch.randn(B, nq, hd, generator=g, device="cuda").to(torch.bfloat16)
        kt = torch.randn(L, B, nkv, hd, C, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(L, B, nkv, C, hd, generator=g, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn(B, nkv, hd, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        mask, live = edge_case_mask(B, C)
        plan = decode_attention_plan(B, nkv, nq // nkv, hd, C)
        for mode, kw in (("base", {}), ("sideband", dict(k_new=kn, v_new=vn, new_valid=live))):
            got = decode_attention_cached(q, kt, v, 1, mask, **kw)
            ref = decode_attention_plain(q, kt, v, 1, mask, **kw)
            _assert_close(f"decode_attention edge cases B={B} {mode}", got, ref, 2e-2, 2e-2)
            if not torch.equal(got, decode_attention_cached(q, kt, v, 1, mask, **kw)):
                raise AssertionError(f"decode_attention edge cases B={B} {mode}: a rerun "
                                     "is not bit-identical")
            errs.append(f"B={B} {mode} (cluster {plan['cluster']}) {_max_err(got, ref):.3g}")
    log("  decode_attention edge cases, reruns bit-identical, max_abs_err: " + "; ".join(errs))


def check_decode_attention_sideband(g):
    """K1's serving mode at phase 5's shapes: 16 layers, cache 384, batch 8
    and 32. Row r holds a left-padded prompt of 20..bucket ids in a bucket
    of 32, 64 or 128 slots, then 0..127 frames; this step's column goes to
    the slot after them, and about a quarter of the rows (and row 1) do not
    count it; each checked against the plain version, rerun bit-identical.
    Returns the batch-32 row; batch 8 is logged."""
    from kalle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cached, decode_attention_plain, decode_attention_plan)

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
        if not torch.equal(got, kernel(7)):
            raise AssertionError(f"decode_attention_sideband B={B}: a rerun is not "
                                 "bit-identical")
        err = _max_err(got, ref)
        plan = decode_attention_plan(B, nkv, nq // nkv, hd, C)
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
            f"max_abs_err {err:.4g} (tolerance 2e-2 abs + 2e-2 rel) cluster "
            f"{plan['cluster']} stages {plan['stages']}, rerun bit-identical")
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
    """K3 at both serving batches (M 8 and 32 pick different instances) and
    at M 72 (two row tiles, the second ragged): within 1e-2 relative of the
    plain version, a second launch bit-identical to the first; timed over
    16 layers' weights beside the plain version and a composed yardstick
    (`torch.matmul` of x with the pre-dequantized bf16 [wg | wu], `silu(g)
    * u`, `torch.matmul` with the bf16 wd: three calls on twice the bytes,
    logged in the note). The row of the kernels line is M 32; M 8 and 72
    are logged."""
    from torch.nn.functional import silu

    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp, fused_mlp_plain, fused_mlp_plan

    L, H, F = 16, 2048, 8192
    wg, wu, wd = (_int8_layers(g, L, *s) for s in ((H, F), (H, F), (F, H)))
    wgu_deq = torch.cat([(q.float() * s[:, None]).to(torch.bfloat16) for q, s in (wg, wu)],
                        dim=2)
    wd_deq = (wd[0].float() * wd[1][:, None]).to(torch.bfloat16)

    def layer(i):
        return [{"q": q[i], "scale": s[i]} for q, s in (wg, wu, wd)]

    def composed(x, i):
        gu = torch.matmul(x, wgu_deq[i])
        return torch.matmul(silu(gu[:, :F]) * gu[:, F:], wd_deq[i])

    xs = _x_rows(g, H)
    xs[72] = torch.randn(72, H, generator=g, device="cuda").to(torch.bfloat16)
    rows = {}
    for M, x in sorted(xs.items()):
        got, ref = fused_mlp(x, *layer(5)), fused_mlp_plain(x, *layer(5))
        rel = _rel_err(got, ref)
        if rel > 1e-2:
            raise AssertionError(f"fused_mlp M={M}: relative error {rel:.4g} > 1e-2")
        if not torch.equal(fused_mlp(x, *layer(5)), got):
            raise AssertionError(f"fused_mlp M={M}: a rerun is not bit-identical")
        li = iter(range(10 ** 9))
        kern = cuda_ms(lambda: fused_mlp(x, *layer(next(li) % L)), 64)
        plain = cuda_ms(lambda: fused_mlp_plain(x, *layer(next(li) % L)), 16)
        comp = cuda_ms(lambda: composed(x, next(li) % L), 64)
        nbytes = 3 * H * F + (2 * F + H) * 4 + 2 * M * H * 2
        plan = fused_mlp_plan(M, H, F)
        rows[M] = dict(name="fused_mlp", source="kalle_tpu_torch/csrc/qmm.cu",
                       replaces="kalle_tpu/ops/pallas/qmm.py:151",
                       max_abs_err=_max_err(got, ref), ms=kern, plain_ms=plain,
                       library_ms=None, work=(nbytes, 3 * 2 * M * H * F),
                       note=f"one layer, M={M}, int8 (tolerance 1e-2 relative, rerun "
                            f"bit-identical); composed_ms {comp:.4f} (matmul [wg|wu], "
                            f"silu*u, matmul wd on pre-dequantized bf16); "
                            f"{plan['clusters']} clusters of {plan['cluster']} blocks, "
                            f"{plan['stages']} stages")
    log_row(rows[8])
    log_row(rows[72])
    return rows[BATCH]


def check_qmm_wqkv(g):
    """K2 on the fused decode layout's wq|wk|wv (2048, 3072), one launch
    a layer, at M 8, 32 (the kernels line's row) and 72: within 1e-2
    relative of the plain version, a rerun bit-identical, and against the
    three separate launches on the same weights (bf16 tolerance, the max
    error printed); timed beside those three launches and `torch.matmul`
    on the pre-dequantized bf16 (2048, 3072) (B7's yardstick)."""
    from kalle_tpu_torch.ops.kernels.qmm import qmm, qmm_plain

    L, H = 16, 2048
    cols = (2048, 512, 512)
    parts = [_int8_layers(g, L, H, n) for n in cols]
    q = torch.cat([w for w, _ in parts], dim=2)
    s = torch.cat([sc for _, sc in parts], dim=1)
    deq = (q.float() * s[:, None]).to(torch.bfloat16)
    xs = {M: torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)
          for M in (8, BATCH, 72)}
    rows = {}
    for M, x in xs.items():
        got, ref = qmm(x, q[5], s[5]), qmm_plain(x, q[5], s[5])
        if _rel_err(got, ref) > 1e-2:
            raise AssertionError(f"qmm wqkv M={M}: relative error {_rel_err(got, ref):.4g}")
        if not torch.equal(qmm(x, q[5], s[5]), got):
            raise AssertionError(f"qmm wqkv M={M}: a rerun is not bit-identical")
        three = torch.cat([qmm(x, w[5], sc[5]) for w, sc in parts], dim=1)
        e3 = _max_err(got, three)
        if not torch.allclose(got.float(), three.float(), atol=2e-2, rtol=2e-2):
            raise AssertionError(f"qmm wqkv M={M}: one launch vs three, max abs err {e3:.4g}")
        kern = cuda_ms(each_layer(lambda i: qmm(x, q[i], s[i]), L), 64)
        sep = cuda_ms(each_layer(lambda i: [qmm(x, w[i], sc[i]) for w, sc in parts], L), 64)
        plain = cuda_ms(each_layer(lambda i: qmm_plain(x, q[i], s[i]), L), 16)
        lib = cuda_ms(each_layer(lambda i: torch.matmul(x, deq[i]), L), 64)
        n = sum(cols)
        rows[M] = dict(name="qmm_wqkv", source="kalle_tpu_torch/csrc/qmm.cu",
                       replaces="kalle_tpu/ops/pallas/qmm.py:74", max_abs_err=_max_err(got, ref),
                       ms=kern, plain_ms=plain, library_ms=lib,
                       work=(H * n + n * 4 + M * H * 2 + M * n * 2, 2 * M * H * n),
                       note=f"fused wq|wk|wv (2048, 3072), M={M}, one launch; three "
                            f"launches {sep:.4f} ms; vs three max_abs_err {e3:.4g} "
                            "(tolerance 1e-2 relative vs plain, 2e-2 vs three; rerun "
                            "bit-identical)")
    log_row(rows[8])
    log_row(rows[72])
    return rows[BATCH]


def check_fused_mlp_gu(g):
    """K3's fused mode (wg | wu as one (2048, 16384) matrix) at M 8, 32
    (the kernels line's row) and 72: bit-identical to the unfused K3 on
    the same weights, within 1e-2 relative of the plain version, a rerun
    bit-identical; timed beside the unfused K3."""
    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp, fused_mlp_plain

    L, H, F = 16, 2048, 8192
    wg, wu, wd = (_int8_layers(g, L, *s) for s in ((H, F), (H, F), (F, H)))
    gu = (torch.cat([wg[0], wu[0]], dim=2), torch.cat([wg[1], wu[1]], dim=1))

    def fused(i):
        return {"q": gu[0][i], "scale": gu[1][i]}, None, {"q": wd[0][i], "scale": wd[1][i]}

    def split(i):
        return [{"q": q[i], "scale": s[i]} for q, s in (wg, wu, wd)]

    rows = {}
    for M in (8, BATCH, 72):
        x = torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)
        got = fused_mlp(x, *fused(5))
        if not torch.equal(got, fused_mlp(x, *split(5))):
            raise AssertionError(f"fused_mlp_gu M={M}: not bit-identical to the unfused K3")
        if not torch.equal(fused_mlp(x, *fused(5)), got):
            raise AssertionError(f"fused_mlp_gu M={M}: a rerun is not bit-identical")
        ref = fused_mlp_plain(x, *fused(5))
        if _rel_err(got, ref) > 1e-2:
            raise AssertionError(f"fused_mlp_gu M={M}: relative error {_rel_err(got, ref):.4g}")
        kern = cuda_ms(each_layer(lambda i: fused_mlp(x, *fused(i)), L), 64)
        unfused = cuda_ms(each_layer(lambda i: fused_mlp(x, *split(i)), L), 64)
        plain = cuda_ms(each_layer(lambda i: fused_mlp_plain(x, *fused(i)), L), 16)
        rows[M] = dict(name="fused_mlp_gu", source="kalle_tpu_torch/csrc/qmm.cu",
                       replaces="kalle_tpu/ops/pallas/qmm.py:151",
                       max_abs_err=_max_err(got, ref), ms=kern, plain_ms=plain,
                       library_ms=None,
                       work=(3 * H * F + (2 * F + H) * 4 + 2 * M * H * 2, 3 * 2 * M * H * F),
                       note=f"fused [wg | wu] (2048, 16384) + wd, M={M}; bit-identical to "
                            f"the unfused K3 ({unfused:.4f} ms); tolerance 1e-2 relative, "
                            "rerun bit-identical")
    log_row(rows[8])
    log_row(rows[72])
    return rows[BATCH]


# SigmaVAE decoder residual blocks at batch 32, 128 frames: (C, T)
CONVNEXT_SHAPES = ((512, 128), (512, 1024), (256, 5120), (128, 25600), (64, 102400))
# the encoder's residual blocks for a 4 s voice prompt at 24 kHz, batch 1:
# (C, T) after each stage's strided downsampling (4, 4, 5, 5, 8)
ENCODER_SHAPES = ((64, 24000), (128, 6000), (256, 1200), (512, 240), (512, 30))


def check_convnext(g):
    """K4 at the decoder's shapes (the kernels line's row) and at the
    encoder's (printed as their own sum); the same bar at both. The
    encoder's inputs come from a generator of their own, so the checks
    after this one keep their inputs."""
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.ops.kernels.convnext_block import (
        convnext_block, convnext_block_plain)

    cfg = sigmavae.SigmaVAEConfig()
    tots = {}
    for where, batch, shapes, g in (
            ("decoder", BATCH, CONVNEXT_SHAPES, g),
            ("encoder", 1, ENCODER_SHAPES, torch.Generator(device="cuda").manual_seed(4))):
        tot = tots[where] = dict(ms=0.0, plain_ms=0.0, err=0.0, nbytes=0, flops=0)
        for c, t in shapes:
            blk = sigmavae.init_params(dataclasses.replace(cfg, channels=(c, c), strides=(4,)),
                                       g, "cuda")["decoder"]["stages"][0]["blocks"][0]
            args = [a.to(torch.bfloat16) for a in (
                blk["norm"], blk["dw"]["w"], blk["dw"]["b"], blk["up"]["w"], blk["up"]["b"],
                blk["down"]["w"], blk["down"]["b"])]
            x = torch.randn(batch, t, c, generator=g, device="cuda").to(torch.bfloat16)
            what = f"convnext_block {where} B={batch} C={c} T={t}"
            got, ref = convnext_block(x, *args), convnext_block_plain(x, *args)
            _assert_close(what, got, ref, 2e-2, 2e-2)
            if not torch.equal(convnext_block(x, *args), got):
                raise AssertionError(f"{what}: a rerun is not bit-identical")
            iters = 20 if batch * t <= 32 * 5120 else 5
            k_ms = cuda_ms(lambda: convnext_block(x, *args), iters)
            p_ms = cuda_ms(lambda: convnext_block_plain(x, *args), max(2, iters // 4))
            err = _max_err(got, ref)
            nbytes = 2 * batch * t * c * 2 + sum(a.numel() * 2 for a in args)
            flops = batch * t * (12 * c * c + 14 * c)
            b_ms, b_by = bound(nbytes, flops)
            log(f"  {what}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by}, {k_ms / b_ms:.2f}x) max_abs_err {err:.4g} "
                "(tolerance 2e-2 abs + 2e-2 rel, rerun bit-identical)")
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["err"] = max(tot["err"], err)
            tot["nbytes"] += nbytes
            tot["flops"] += flops
            del x, got, ref
            torch.cuda.empty_cache()
    enc = tots["encoder"]
    b_ms, b_by = bound(enc["nbytes"], enc["flops"])
    log(f"  convnext_block encoder sum (one block at each of the 5 widths, batch 1, 4 s): "
        f"kernel_ms {enc['ms']:.4f} plain_ms {enc['plain_ms']:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}, {enc['ms'] / b_ms:.2f}x) max_abs_err {enc['err']:.4g}")
    tot = tots["decoder"]
    tot["err"] = max(tot["err"], enc["err"])
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
    errs = {"flash_fwd": _max_err(o, o_ref),
            **check_flash_bwd(fa, q, k, v, pad, do, lse_ref, delta, "")}
    log(f"  flash LSE max_abs_err {_max_err(lse[~masked], lse_ref[~masked]):.4g}; "
        f"dQ {errs['flash_bwd_dq']:.4g} dK/dV {errs['flash_bwd_dkv']:.4g}")

    # the library yardstick: SDPA (GQA, bool mask) forward, and its backward
    # alone (dq, dk, dv from one saved forward: the work of K6 + K7)
    lib_fwd, lib_bwd = sdpa_times(q, k, v, pad, do)

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
             + 2 * (k.numel() + v.numel()), lib_bwd)):
        rows.append(dict(name=name, source="kalle_tpu_torch/csrc/flash_attention.cu",
                         replaces=replaces, max_abs_err=errs[name], ms=cuda_ms(fn, 10),
                         plain_ms=cuda_ms(plain, 3), library_ms=lib,
                         work=(nbytes, pairs * products * 2 * hd)))
    rows[0]["note"] = "SDPA forward as library_ms"
    rows[2]["note"] = "SDPA backward alone as library_ms: dq, dk and dv, i.e. K6 + K7"
    log(f"  K6 + K7 {rows[1]['ms'] + rows[2]['ms']:.4f} ms against SDPA's backward alone "
        f"{lib_bwd:.4f} ms ({(rows[1]['ms'] + rows[2]['ms']) / lib_bwd:.3f}x)")
    check_flash_hd128(g)
    return rows


def check_flash_bwd(fa, q, k, v, pad, do, lse, delta, what):
    """K6 and K7 against their plain versions (2e-2 abs + 2e-2 rel); dQ rows
    of queries with no valid key and dK/dV rows of padded keys exactly 0; a
    second launch of each bit-identical to the first. -> the largest
    errors."""
    args = (q, k, v, pad, do, lse, delta)
    dq, dq_ref = fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args)
    _assert_close(f"flash_bwd_dq{what}", dq, dq_ref, 2e-2, 2e-2)
    dk, dv = fa.flash_bwd_dkv(*args)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
    _assert_close(f"flash_bwd_dkv dK{what}", dk, dk_ref, 2e-2, 2e-2)
    _assert_close(f"flash_bwd_dkv dV{what}", dv, dv_ref, 2e-2, 2e-2)
    dead_q = (lse <= fa.NEG / 2).transpose(1, 2)  # (b, t, nq)
    dead_k = pad == 0
    if not (dead_q.any() and dead_k.any() and torch.all(dq[dead_q] == 0)
            and torch.all(dk[dead_k] == 0) and torch.all(dv[dead_k] == 0)):
        raise AssertionError(f"flash backward{what}: a dead row is not exactly 0")
    again = fa.flash_bwd_dkv(*args)
    if not (torch.equal(fa.flash_bwd_dq(*args), dq) and torch.equal(again[0], dk)
            and torch.equal(again[1], dv)):
        raise AssertionError(f"flash backward{what}: a rerun is not bit-identical")
    return {"flash_bwd_dq": _max_err(dq, dq_ref),
            "flash_bwd_dkv": max(_max_err(dk, dk_ref), _max_err(dv, dv_ref))}


def sdpa_times(q, k, v, pad, do):
    """SDPA (GQA, the same causal + padding bool mask) at K5-K7's inputs:
    the forward (a CUDA graph's replay) and the backward alone
    (`torch.autograd.grad` of one saved forward: its kernels' device time
    over 10 calls from the profiler, since CUDA events around the calls
    also time autograd's host work); logs which backend's kernels ran."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    am = (pos[None, :] <= pos[:, None])[None, None] & pad.bool()[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am, enable_gqa=True), 10)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    og = sdpa(qg, kg, vg, attn_mask=am, enable_gqa=True)
    dot_ = do.transpose(1, 2)

    def bwd():
        return torch.autograd.grad(og, (qg, kg, vg), dot_, retain_graph=True)

    events_ms = event_ms(bwd, 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            bwd()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    bwd_ms = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
    log(f"  sdpa (enable_gqa, bool mask) at b {q.shape[0]}, t {t}, {q.shape[2]}/"
        f"{k.shape[2]} heads, hd {q.shape[3]}: forward_ms {fwd:.4f} backward_alone_ms "
        f"{bwd_ms:.4f} (its kernels' device time; CUDA events around the calls "
        f"{events_ms:.4f}, autograd's host work included); backward kernels "
        f"{sorted(e.key[:60] for e in kernels)}")
    return fwd, bwd_ms


def check_flash_hd128(g):
    """K5-K7's bf16 tensor-core instances at hd 128 (the training shape
    reaches only hd 64): b 4, t 512, 16/4 heads, ragged right padding, a
    left-padded row and a row with no valid key; O, dQ, dK, dV 2e-2 abs +
    2e-2 rel, LSE 1e-3 abs + 1e-4 rel, the dead rows identical (forward) or
    exactly 0 (backward), reruns of K6/K7 bit-identical. Logged with the
    plain and SDPA times (forward; backward alone against K6 + K7)."""
    from kalle_tpu_torch.ops.kernels import flash_attention as fa

    b, t, nq, nkv, hd = 4, TRAIN_T, 16, 4, 128
    dev, bf = "cuda", torch.bfloat16
    q, do = (torch.randn(b, t, nq, hd, generator=g, device=dev).to(bf) for _ in range(2))
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
    delta = fa.attention_delta(o_ref, do)
    errs = check_flash_bwd(fa, q, k, v, pad, do, lse_ref, delta, " hd 128")
    args = (q, k, v, pad, do, lse_ref, delta)
    l_fwd, l_bwd = sdpa_times(q, k, v, pad, do)
    pairs = float(pad.cumsum(-1).sum()) * nq
    e_in = 2 * (q.numel() + k.numel() + v.numel()) + 4 * b * t
    for name, fn, plain, nbytes, products, lib in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, pad),
             lambda: fa.flash_attention_fwd_plain(q, k, v, pad),
             e_in + 2 * q.numel() + 4 * b * nq * t, 2, l_fwd),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*args), lambda: fa.flash_bwd_dq_plain(*args),
             e_in + 4 * q.numel() + 8 * b * nq * t, 3, None),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*args),
             lambda: fa.flash_bwd_dkv_plain(*args),
             e_in + 2 * do.numel() + 8 * b * nq * t + 2 * (k.numel() + v.numel()), 4, l_bwd)):
        b_ms, b_by = bound(nbytes, pairs * products * 2 * hd)
        err = _max_err(o, o_ref) if name == "flash_fwd" else errs[name]
        lib = "none alone" if lib is None else f"{lib:.4f}"
        log(f"  {name} hd 128 (b {b}, t {t}, {nq}/{nkv} heads): kernel_ms "
            f"{cuda_ms(fn, 10):.4f} plain_ms {cuda_ms(plain, 3):.4f} sdpa_ms {lib} "
            f"bound_ms {b_ms:.4f} ({b_by}) max_abs_err {err:.4g}")
    log(f"  flash_fwd hd 128 LSE max_abs_err {_max_err(lse[~dead], lse_ref[~dead]):.4g}")


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
    # the fused decode layout's K2 and K3 rows, from a generator of their
    # own so that the checks above keep their inputs
    g7 = torch.Generator(device="cuda").manual_seed(7)
    for check in (check_qmm_wqkv, check_fused_mlp_gu):
        rows.append(check(g7))
        torch.cuda.empty_cache()
    for r in rows:
        log_row(r)
    return rows


# --------------------------------------------------------------- phase 3 ----

def flagship_int8(g):
    """The flagship's params in bf16 with int8 layer weights, from `g`."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    params = llasa.init_params(flagship_cfg(), g, "cuda")
    return quantize_llama_params(tree_map(lambda t: t.to(torch.bfloat16), params))


def phase_slice(card: str):
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.ops.kernels import _build

    log("# phase 3: text -> 24 kHz wav, flagship width, batch 32")
    cfg = flagship_cfg()
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
    for label, pat in (("K3 fused_mlp (k3::mlp_kernel + k3::sum_kernel)", "k3::"),
                       ("K4 convnext_block (convnext_tc_kernel)", "convnext_tc_kernel")):
        mine = [e for e in kernels if pat in e.key]
        if mine:
            log(f"    {label}: device_ms {sum(e.self_device_time_total for e in mine) / 1e3:.3f}"
                f" in {sum(e.count for e in mine)} kernel launches")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 12 or "flash_" in e.key:  # the top 12, and K5-K7 wherever they rank
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
    cfg = flagship_cfg()
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
    full-width model, which amplifies bf16 rounding about 1.6x a frame. The
    bar there is that amplification of rounding-level noise, measured with
    no kernel under test: `generate` with the MLP through K3's plain
    version, once as it is and once with the FFN columns in reverse order
    (wg's and wu's columns, wd's rows: the same f32 sums over F in another
    order, the kind of difference K1's sideband makes in attention). Frames
    0-7 (six decode steps that read written columns) must each stay within
    max(2e-2, 4 x that departure's largest value up to the frame).

    The check must also see a fault of one slot: the batcher again, with
    row 0's new column dropped from K1's sideband in every decode step,
    must fail the same bar in both dtypes. The whole curves are printed."""
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.infer import serve_loop
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.models.lm import llama, llasa
    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp_plain

    n, gated = 16, 8

    def patched(module, name, fn, run):
        """run() with module.name replaced by fn."""
        kept = getattr(module, name)
        setattr(module, name, fn)
        try:
            return run()
        finally:
            setattr(module, name, kept)

    def plain_mlp(x, wg, wu, wd, reverse=False):
        if reverse:  # F in reverse order: the same sums, another order
            wg, wu = ({"q": w["q"].flip(1), "scale": w["scale"].flip(0)} for w in (wg, wu))
            wd = {"q": wd["q"].flip(0), "scale": wd["scale"]}
        return fused_mlp_plain(x, wg, wu, wd)

    sideband = serve_loop.decode_attention_cached

    def dropped_slot(*args, new_valid=None, **kw):
        """K1 with row 0's new column not counted (the planted fault)."""
        if new_valid is not None:
            new_valid = new_valid.clone()
            new_valid[0] = False
        return sideband(*args, new_valid=new_valid, **kw)

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

    def batched(cfg, params):
        cb = serve_loop.ContinuousBatcher(params, cfg, batch_size=4, max_frames=n + 1,
                                          prompt_buckets=SERVE_BUCKETS, greedy=True)
        comps = {c.index: c.means for c in cb.run(prompts)}
        got = [comps[i] for i in range(len(prompts))]
        if any(a.shape != (n, 64) for a in got):
            raise AssertionError(f"cross-check: shapes {[a.shape for a in got]}")
        return got, cb.state.k.shape[-1]

    def curve(got, ref):
        """Per frame, the largest |difference| over the prompts, over the
        largest |mean| of the reference."""
        return np.max([np.abs(a - b).max(axis=1) / np.abs(b).max()
                       for a, b in zip(got, ref)], axis=0)

    def fmt(c):
        return " ".join(f"{x:.2e}" for x in c)

    f32 = LlasaConfig(llama=dataclasses.replace(LlamaConfig(), dtype="float32"),
                      latent_dim=64, audio_proj_dim=2048, head_variant="sigma")
    f32_params = llasa.init_params(f32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    failed = []
    for what, cfg, params in (("bf16 int8", flagship_cfg(), params_int8),
                              ("f32", f32, f32_params)):
        got, cache_len = batched(cfg, params)
        ref = generated(cfg, params, cache_len)
        err = curve(got, ref)
        log(f"  serve cross-check {what}: batcher vs generate, 4 prompts, per frame max "
            f"|diff| / max |generate|: {fmt(err)}")
        if what == "f32":
            bar = np.full(n, 1e-3)
        else:
            plain = patched(llama, "fused_mlp", plain_mlp,
                            lambda: generated(cfg, params, cache_len))
            noise = curve(patched(llama, "fused_mlp",
                                  lambda *a: plain_mlp(*a, reverse=True),
                                  lambda: generated(cfg, params, cache_len)), plain)
            bar = np.maximum(2e-2, 4 * np.maximum.accumulate(noise))
            bar[gated:] = np.inf
            log(f"    noise: generate through K3's plain version, F reversed vs as it is: "
                f"{fmt(noise)}")
        log(f"    tolerance per frame: {fmt(bar)}; worst share of it {np.max(err / bar):.4g}")
        if not (err <= bar).all():
            failed.append(what)
        fault = curve(patched(serve_loop, "decode_attention_cached", dropped_slot,
                              lambda: batched(cfg, params)[0]), ref)
        log(f"    planted fault (row 0's new column dropped from K1's sideband): "
            f"{fmt(fault)}; worst share of the bar {np.max(fault / bar):.4g}")
        if (fault <= bar).all():
            failed.append(f"{what}: the bar does not see the planted fault")
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
    stream = make_stream_fn(params, flagship_cfg(), tok, codec, chunk_frames=25,
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


# --------------------------------------------------------------- phase 6 ----

K1_K4 = ("decode_attention", "qmm", "fused_mlp", "convnext_block")
TINY_YAML = """project_name: tiny
model:
  latent_dim: 8
  audio_proj_dim: 64
  llama: {vocab_size: 265, hidden_size: 64, intermediate_size: 128, num_layers: 2,
          num_heads: 4, num_kv_heads: 2, head_dim: 16, max_seq_len: 128, dtype: float32}
"""


def check_launches(what: str, got: dict, expect: dict) -> None:
    """K1-K4's counts of one run against what the path implies, exactly."""
    for name in K1_K4:
        if got.get(name, 0) != expect.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {got.get(name, 0)} times, "
                                 f"the path implies {expect.get(name, 0)}")
    log(f"  {what}: launches " + json.dumps({k: got.get(k, 0) for k in K1_K4})
        + " (as the path implies)")


def phase_infer(card: str):
    """InferTools at full width: infer_jsonl, a voice prompt through the
    demo's synthesize fn, a small card-vs-CPU check, the CLI. Returns K4's
    launches in the counted runs and the voice prompt's encoded latents."""
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.infer.pipeline import Codec, InferTools
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.serve.web import make_synthesize_fn
    from kalle_tpu_torch.utils.audio import read_wav, resample_linear

    log(f"# phase 6: InferTools at full width: infer_jsonl of {INFER_ROWS} rows, "
        f"{INFER_FRAMES} frames, a {PROMPT_S} s voice prompt")
    cfg = flagship_cfg()
    L = cfg.llama.num_layers
    params = flagship_int8(torch.Generator(device="cuda").manual_seed(0))  # phase 3's weights
    codec = Codec.random_init("sigma", torch.Generator(device="cuda").manual_seed(6),
                              "cuda").astype(torch.bfloat16)
    blocks = len(codec.cfg.strides) * codec.cfg.blocks_per_stage  # an encode's or a decode's
    hop = codec.samples_per_frame
    # the sigma head never stops early: every generate call takes INFER_FRAMES steps
    decode = {"decode_attention": L * INFER_FRAMES, "qmm": 4 * L * INFER_FRAMES,
              "fused_mlp": L * INFER_FRAMES}
    k4 = 0
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as root:
        rows, frames = [], []
        for i, text in enumerate(serve_texts(INFER_ROWS, rng)):
            frames.append(int(rng.integers(40, 121)))
            path = os.path.join(root, f"lat{i}.npy")
            np.save(path, rng.normal(size=(1, frames[-1], 64)).astype(np.float32))
            rows.append({"id": f"u{i}", "caption": text, "vae": path})
        it = InferTools(cfg, params, ByteTokenizer(), codec, output_root=root,
                        version="phase6", ckpt_name="random", timestamp=False)

        # (a) the test set: one batch of 8 through one bucket, 8 copysyn decodes
        expect = dict(decode, convnext_block=blocks * (INFER_ROWS + 1))
        for run in range(2):  # the first warms this batch's shapes
            _build.reset_launches()
            t0 = time.perf_counter()
            files = it.infer_jsonl(rows, max_frames=INFER_FRAMES, batch_size=INFER_ROWS)
            wall = time.perf_counter() - t0
            check_launches(f"infer_jsonl run {run}", _build.launches(), expect)
            k4 += expect["convnext_block"]
        want = [f"u{i}---{kind}.wav" for i in range(INFER_ROWS) for kind in ("copysyn", "gen")]
        if [os.path.basename(f) for f in files] != want:
            raise AssertionError(f"infer_jsonl wrote {files}")
        for i, n in enumerate(frames):
            with open(os.path.join(it.output_dir, f"u{i}.txt")) as f:
                if f.read() != rows[i]["caption"]:
                    raise AssertionError(f"u{i}.txt does not hold the caption")
            for kind, samples in (("copysyn", n * hop), ("gen", (INFER_FRAMES - 1) * hop)):
                a, sr = read_wav(os.path.join(it.output_dir, f"u{i}---{kind}.wav"))
                if sr != 24000 or a.shape != (1, samples) or not np.isfinite(a).all():
                    raise AssertionError(f"u{i}---{kind}.wav: {sr} Hz {a.shape}, "
                                         f"want 24000 Hz (1, {samples})")
        audio_s = INFER_ROWS * (INFER_FRAMES - 1) * hop / 24000
        log(f"infer_jsonl rows {INFER_ROWS} wall_s {wall:.4f} rtf {wall / audio_s:.6g} "
            f"gen_audio_s {audio_s:.2f} (second run; copysyn decodes and wav writes "
            f"included) card {card}")

        # (b) a 4 s 16 kHz int16 reference: resample, bf16 encode (K4), synthesize
        t = np.arange(PROMPT_S * PROMPT_SR) / PROMPT_SR
        ref = (PROMPT_SR, (np.sin(2 * np.pi * 180 * t) * (0.3 + 0.2 * np.sin(3 * t)) * 32767
                           + rng.normal(0, 300, t.size)).clip(-32768, 32767).astype(np.int16))
        wav24 = resample_linear(ref[1][None].astype(np.float32) / 32768, PROMPT_SR, 24000)
        n_prompt = wav24.shape[-1] // hop
        codec.encode_audio(wav24[None])  # warm-up
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            z = codec.encode_audio(wav24[None])
        enc_ms = (time.perf_counter() - t0) / ITERS * 1e3
        check_launches(f"encode_audio x{ITERS}", _build.launches(),
                       {"convnext_block": blocks * ITERS})
        k4 += blocks * ITERS
        if z.shape != (1, n_prompt, 64) or not np.isfinite(z).all():
            raise AssertionError(f"encode_audio gave {z.shape}, want (1, {n_prompt}, 64)")
        log(f"encode_audio {PROMPT_S} s prompt (bf16, K4 in {blocks} blocks): ms {enc_ms:.3f} "
            f"frames {n_prompt} (host clock, H2D and D2H included) card {card}")

        seen = []
        synthesize = it.synthesize

        def spy(text, max_frames=200, prompt_latents=None):
            seen.append(None if prompt_latents is None else prompt_latents.shape)
            return synthesize(text, max_frames=max_frames, prompt_latents=prompt_latents)

        it.synthesize = spy
        fn = make_synthesize_fn(it, max_frames=INFER_FRAMES)
        for run in range(2):  # the first warms batch 1's shapes
            _build.reset_launches()
            t0 = time.perf_counter()
            sr, out = fn(ref, "", "a voice prompted test sentence", True)
            wall_p = time.perf_counter() - t0
            check_launches(f"voice-prompted synthesize run {run}", _build.launches(),
                           dict(decode, convnext_block=2 * blocks))
            k4 += 2 * blocks
        if (seen != [(n_prompt, 64)] * 2 or sr != 24000 or out.dtype != np.int16
                or out.shape != ((INFER_FRAMES - 1) * hop,)):
            raise AssertionError(f"voice prompt {seen}, output {sr} Hz {out.dtype} {out.shape}")
        log(f"synthesize with a voice prompt ({n_prompt} frames) wall_s {wall_p:.4f} "
            f"rtf {wall_p / ((INFER_FRAMES - 1) * hop / 24000):.6g} (resample, encode, "
            f"generate, decode; second run) card {card}")
    del params
    torch.cuda.empty_cache()
    infer_reference()
    infer_cli()
    return k4, z


def infer_reference():
    """(c) A small f32 model with int8 layer weights and a small f32 codec,
    on the card (kernels) and on the CPU (plain versions): encode, greedy
    generate with the encoded prompt and an embed bias, decode (1e-3)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    llama = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, dtype="float32")
    cfg = LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=256)
    params = quantize_llama_params(llasa.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"))
    vcfg = sigmavae.SigmaVAEConfig(strides=(2, 4), channels=(64, 128))
    codec = Codec.random_init("sigma", torch.Generator().manual_seed(1), "cpu", cfg=vcfg)
    g = torch.Generator().manual_seed(2)
    wav = 0.3 * torch.randn(2, 1, 40 * vcfg.hop, generator=g)
    ids = torch.randint(0, 300, (2, 9), generator=g)
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    bias = 0.1 * torch.randn(2, 256, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        _build.reset_launches()
        p = tree_map(lambda t: t.to(dev), params)
        c = Codec("sigma", vcfg, tree_map(lambda t: t.to(dev), codec.params))
        z = sigmavae.encode(c.params, vcfg, wav.to(dev))
        res = generate(p, cfg, ids.to(dev), mask.to(dev), max_frames=8, greedy=True,
                       prompt_latents=z, embed_bias=bias.to(dev))
        out[dev] = (z.cpu(), res.means.cpu(), res.n_frames.cpu(), c.decode_latents(res.means))
    L = llama.num_layers
    check_launches("card vs CPU, small f32 model (card run)", _build.launches(),
                   {"decode_attention": 8 * L, "qmm": 32 * L, "fused_mlp": 8 * L})
    (zc, mc, nc, wc), (zg, mg, ng, wg) = out["cpu"], out["cuda"]
    if not torch.equal(nc, ng):
        raise AssertionError("n_frames differ between card and CPU")
    errs = [_max_err(zg, zc), _max_err(mg, mc), float(np.abs(wg - wc).max())]
    log(f"  card vs CPU (f32 encode, greedy prompted generate, decode) max_abs_err "
        f"encode {errs[0]:.3g} latents {errs[1]:.3g} wav {errs[2]:.3g} (limit 1e-3)")
    if max(errs) > 1e-3 or not np.isfinite(wg).all():
        raise AssertionError("the card's inference path disagrees with the plain CPU path")


def infer_cli():
    """(d) `python -m kalle_tpu_torch.infer.cli` in a process of its own on
    the default device (the card), a tiny model with int8 layer weights."""
    from kalle_tpu_torch.core.checkpoint import save_params_npz
    from kalle_tpu_torch.core.config import load_experiment_config
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params
    from kalle_tpu_torch.utils.audio import read_wav

    with tempfile.TemporaryDirectory() as root:
        yaml = os.path.join(root, "tiny.yaml")
        with open(yaml, "w") as f:
            f.write(TINY_YAML)
        cfg = load_experiment_config(yaml).model
        ckpt = os.path.join(root, "tiny_int8.npz")
        save_params_npz(ckpt, quantize_llama_params(
            llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
        rng = np.random.default_rng(7)
        rows = []
        for i in range(3):
            lat = os.path.join(root, f"lat{i}.npy")
            np.save(lat, rng.normal(size=(1, 5 + i, 8)).astype(np.float32))
            rows.append(json.dumps({"id": f"t{i}", "caption": f"tiny row {i}", "vae": lat}))
        meta = os.path.join(root, "meta.jsonl")
        with open(meta, "w") as f:
            f.write("\n".join(rows))
        cmd = [sys.executable, "-m", "kalle_tpu_torch.infer.cli", "-c", yaml, "-i", meta,
               "-o", os.path.join(root, "out"), "-p", ckpt, "--limit", "2", "-m", "8"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"infer.cli exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        wrote = [ln for ln in lines if ln.startswith("wrote ")]
        if len(wrote) != 1 or not wrote[0].startswith("wrote 4 files to "):
            raise AssertionError(f"infer.cli printed {lines}")
        run_dir = wrote[0].removeprefix("wrote 4 files to ")
        got = json.loads(lines[lines.index(wrote[0]) + 1].removeprefix("kernel launches "))
        L = cfg.llama.num_layers
        check_launches("infer.cli subprocess", got,
                       {"decode_attention": 8 * L, "qmm": 32 * L, "fused_mlp": 8 * L})
        for name, samples in (("t0---copysyn.wav", 5 * 3200), ("t1---copysyn.wav", 6 * 3200),
                              ("t0---gen.wav", 7 * 3200), ("t1---gen.wav", 7 * 3200)):
            a, sr = read_wav(os.path.join(run_dir, name))
            if sr != 24000 or a.shape != (1, samples) or not np.isfinite(a).all():
                raise AssertionError(f"infer.cli {name}: {sr} Hz {a.shape}")
        log(f"  infer.cli subprocess on the card: {wrote[0]!r}, wall_s {wall:.2f} "
            "(process start included)")


# --------------------------------------------------------------- phase 7 ----

# (b): optimizer steps, checkpoints kept; (e): int4 frames; (f): prompt_fit steps
WARM_STEPS, WARM_KEEP, INT4_FRAMES, FIT_STEPS = 4, 2, 16, 3


def train_model():
    """Phase 4's model: the flagship's widths with f32 master weights and
    bf16 compute, flash attention on."""
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig

    return LlasaConfig(llama=LlamaConfig(use_flash_attention=True), latent_dim=64,
                       audio_proj_dim=2048, head_variant="sigma")


def _leaves_equal(a, b) -> bool:
    from kalle_tpu_torch.bridge import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and torch.equal(x, y.to(x.device))
                                      for x, y in zip(la, lb))


def phase_port_closure(card: str, prompt_z: np.ndarray) -> dict:
    """Phase 7: the reference checkpoint round trip, warm-started training
    with async checkpoints and the eval-audio hook, the fused decode layout
    (K2 on wqkv, K3's fused mode) in generate and the batcher, int4 decode,
    and prompt_fit at full width. Returns the launches of its counted runs."""
    log("# phase 7: checkpoints, warm start, eval hook, fused decode, int4, prompt_fit")
    counts: dict = {}
    with tempfile.TemporaryDirectory() as root:
        params, path = closure_checkpoint(card, root)
        _add(counts, closure_prompt_fit(card, params, prompt_z))
        torch.cuda.empty_cache()
        _add(counts, closure_warm_start(card, root, path, params))
        del params
    torch.cuda.empty_cache()
    _add(counts, closure_fused(card))
    closure_int4(card)
    return counts


def _add(counts: dict, more: dict) -> None:
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v


def closure_checkpoint(card: str, root: str):
    """(a) Phase 3's weights as an f32 Llasa, exported to a reference-layout
    .pt and read back onto the card: every leaf bit-equal."""
    from kalle_tpu_torch.core.checkpoint import load_reference_llasa_checkpoint
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.models.lm.convert import llasa_state_dict_from_params

    cfg = train_model()
    params = llasa.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    path = os.path.join(root, "epoch_1_step_0.pt")
    t0 = time.perf_counter()
    torch.save(llasa_state_dict_from_params(params, cfg), path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_reference_llasa_checkpoint(path, cfg, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not _leaves_equal(loaded, params):
        raise AssertionError("a leaf of the reference .pt read back differs from its source")
    del loaded
    log(f"  (a) reference .pt round trip: {os.path.getsize(path) / 1e9:.2f} GB, export + "
        f"torch.save {export_s:.2f} s, load onto the card {load_s:.2f} s, every leaf "
        f"bit-equal card {card}")
    return params, path


def closure_prompt_fit(card: str, params: dict, prompt_z: np.ndarray) -> dict:
    """(f) prompt_fit at full width on phase 6's encoded 4 s prompt (sigma:
    log-scale log 0.5), 32 text ids, 3 steps at lr 1e-6: finite losses and
    K5-K7 exactly 16 a step each."""
    from kalle_tpu_torch.infer.optim import prompt_fit
    from kalle_tpu_torch.ops.kernels import _build

    cfg = train_model()
    mean = torch.from_numpy(prompt_z).to("cuda")
    logs = torch.full_like(mean, math.log(cfg.sigma))
    ids = torch.randint(0, 128255, (1, TEXT_LEN),
                        generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    fitted, loss = prompt_fit(params, cfg, ids, mean, logs,
                              torch.Generator(device="cuda").manual_seed(7), lr=1e-6,
                              max_steps=FIT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches().items() if k.startswith("flash")}
    L = cfg.llama.num_layers
    check = {"flash_fwd": L * FIT_STEPS, "flash_bwd_dq": L * FIT_STEPS,
             "flash_bwd_dkv": L * FIT_STEPS}
    if launches != check:
        raise AssertionError(f"prompt_fit launches {launches}, the path implies {check}")
    if not math.isfinite(loss) or not all(torch.isfinite(p).all() for p in
                                          (fitted["llama"]["embed"], fitted["audio_linear"]["w"])):
        raise AssertionError(f"prompt_fit: loss {loss}")
    log(f"prompt_fit steps {FIT_STEPS} s_per_step {wall / FIT_STEPS:.4f} last_loss {loss:.5f} "
        f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f} (prompt "
        f"{tuple(mean.shape)}, {TEXT_LEN} text ids, padded to 128 for flash; the first "
        f"step warms up) card {card}")
    log("  (f) launches " + json.dumps(launches) + " (as the path implies)")
    return launches


def closure_warm_start(card: str, root: str, path: str, params: dict) -> dict:
    """(b) Trainer.fit warm-started from the .pt at phase 4's shape: 4
    steps, a checkpoint every 2 (2 kept), the eval-audio hook on a bf16
    SigmaVAE every 2. The params before step 1 equal the file's; exactly
    steps 2 and 4 are kept; restore(step=2) into a fresh state equals the
    state saved at step 2; every hook wav has its length, is finite, at
    24 kHz; K4 and K5-K7 launch exactly as the path implies. `params` are
    (a)'s, bit-equal to the file's."""
    from kalle_tpu_torch.bridge import tree_leaves
    from kalle_tpu_torch.core.checkpoint import CheckpointManager
    from kalle_tpu_torch.core.config import DataConfig, ExperimentConfig, TrainConfig
    from kalle_tpu_torch.data.tokens import build_tokenizer
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.train.eval_hook import make_eval_audio_hook
    from kalle_tpu_torch.train.step import make_train_state
    from kalle_tpu_torch.train.trainer import Trainer
    from kalle_tpu_torch.utils.audio import read_wav

    cfg = train_model()
    meta = write_latents(root, TRAIN_B * TRAIN_A * WARM_STEPS)
    exp = ExperimentConfig(
        project_name="chip_smoke_warm", exp_dir=os.path.join(root, "exp"), model=cfg,
        start_checkpoint=path,
        train=TrainConfig(lr=5e-5, warmup_steps=2, total_steps=1000,
                          gradient_accumulation_steps=TRAIN_A, end_loss_weight=0.002,
                          log_interval=2, save_interval=2, seed=0),
        data=DataConfig(meta_path=meta, batch_size=TRAIN_B, use_dynamic=False,
                        num_workers=1, prefetch_size=4, length_buckets=(TRAIN_T,),
                        max_length=TRAIN_T))
    codec = Codec.random_init("sigma", torch.Generator(device="cuda").manual_seed(6),
                              "cuda").astype(torch.bfloat16)
    hook_dir = os.path.join(root, "eval_audios")
    hook = make_eval_audio_hook(codec, hook_dir)
    frames, saved = {}, {}

    def spy(trainer, step, np_batch):
        hook(trainer, step, np_batch)
        frames[step] = int(np.asarray(np_batch["audio_mask"][0]).sum())
        if step == 2:  # the state the step-2 checkpoint must hold (copies: AdamW's
            # step counts live on the host and count on in place)
            saved["params"] = [p.detach().to("cpu", copy=True)
                               for p in tree_leaves(trainer.state.params)]
            saved["opt"] = {i: {k: v.detach().to("cpu", copy=True) for k, v in st.items()}
                            for i, st in trainer.state.optimizer.state_dict()["state"].items()}

    t0 = time.perf_counter()
    trainer = Trainer(exp, build_tokenizer(), eval_hook=spy, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainer.ckpt.max_to_keep = WARM_KEEP
    if not _leaves_equal(trainer.state.params, params):
        raise AssertionError("the warm-started params differ from the .pt's")
    del params
    saves = []
    save = trainer.ckpt.save

    def timed_save(step, state, wait=False):
        t = time.perf_counter()
        save(step, state, wait)
        saves.append((step, wait, time.perf_counter() - t))

    trainer.ckpt.save = timed_save
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(max_steps=WARM_STEPS)
    fit_s = time.perf_counter() - t0
    launches = _build.launches()
    L = cfg.llama.num_layers
    hook_calls = WARM_STEPS // exp.train.log_interval
    blocks = len(codec.cfg.strides) * codec.cfg.blocks_per_stage
    expect = {"flash_fwd": L * TRAIN_A * WARM_STEPS + L * hook_calls,  # + the hook's forwards
              "flash_bwd_dq": L * TRAIN_A * WARM_STEPS, "flash_bwd_dkv": L * TRAIN_A * WARM_STEPS,
              "convnext_block": 2 * blocks * hook_calls}  # gen and gt decodes
    for name, n in expect.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"warm-started fit: {name} launched {launches.get(name, 0)} "
                                 f"times, the path implies {n}")
    losses = [h["total_loss"] for h in trainer.history]
    if len(losses) != hook_calls or not all(map(math.isfinite, losses)):
        raise AssertionError(f"warm-started fit losses {losses}")
    steps = trainer.ckpt.steps()
    if steps != [2, 4]:
        raise AssertionError(f"checkpoints kept {steps}, want [2, 4]")
    blocked = sum(t for _, _, t in saves)
    log(f"warm_start fit steps {WARM_STEPS} fit_s {fit_s:.2f} init_s {init_s:.2f} (a 4.9 GB "
        f".pt) save_blocked_s {blocked:.2f} writer_s {trainer.ckpt.write_s:.2f} (saves, "
        "step / wait / seconds blocked: " + ", ".join(f"{s} / {w} / {t:.2f}" for s, w, t in
                                                       saves)
        + f"; the step-2 save writes while steps 3-4 run) losses {[round(x, 5) for x in losses]}"
        f" card {card}")
    log("  (b) launches " + json.dumps({k: launches.get(k, 0) for k in expect})
        + " (as the path implies)")
    hop = codec.samples_per_frame
    for step in (2, 4):
        for kind in ("gen", "gt"):
            a, sr = read_wav(os.path.join(hook_dir, f"sample_{step}-{kind}.wav"))
            if sr != 24000 or a.shape != (1, frames[step] * hop) or not np.isfinite(a).all():
                raise AssertionError(f"sample_{step}-{kind}.wav: {sr} Hz {a.shape}, want "
                                     f"(1, {frames[step] * hop})")
    ckpt_dir = trainer.ckpt.directory
    del trainer
    torch.cuda.empty_cache()
    fresh = make_train_state(llasa.init_params(cfg, torch.Generator(device="cuda")
                                               .manual_seed(1), "cuda"), exp.train)
    t0 = time.perf_counter()
    fresh, at = CheckpointManager(ckpt_dir).restore(fresh, step=2)
    restore_s = time.perf_counter() - t0
    if at != 2 or fresh.step != 2 or not all(
            torch.equal(p.detach().cpu(), q) for p, q in zip(tree_leaves(fresh.params),
                                                              saved["params"])):
        raise AssertionError("restore(step=2) does not give the params saved at step 2")
    for i, st in fresh.optimizer.state_dict()["state"].items():
        if not all(torch.equal(v.detach().cpu(), saved["opt"][i][k]) for k, v in st.items()):
            raise AssertionError("restore(step=2) does not give the AdamW state of step 2")
    log(f"  (b) hook wavs at steps 2 and 4 (gen, gt) at 24 kHz, {frames} frames; "
        f"restore(step=2) into a fresh state in {restore_s:.1f} s: params and AdamW state "
        "equal what was saved")
    del fresh
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in expect}


def small_f32_int8():
    """infer_reference's small f32 model, int8 layer weights, on the CPU."""
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.models.lm import llasa

    llama = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, dtype="float32")
    cfg = LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=256)
    return cfg, llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def closure_fused(card: str) -> dict:
    """(c) generate with the fused decode layout at bench shape, fused and
    unfused in one call, with exact launch counts; K3's fused mode against
    the unfused K3 on one layer at M 8/32/72 (bit-identical), K2 on wqkv
    against three launches; the small f32 model's fused frames against its
    unfused frames on the card (1e-3). (d) The batcher on the fused params:
    16 requests at batch 8; the small f32 model's fused batcher against its
    unfused batcher (1e-3)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.data.tokens import build_prompt_ids, build_tokenizer
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
    from kalle_tpu_torch.models.lm.llama import layer_params
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.ops.kernels.qmm import fused_mlp, qmm
    from kalle_tpu_torch.ops.quant import fuse_decode_params, quantize_llama_params

    cfg = flagship_cfg()
    L = cfg.llama.num_layers
    params = flagship_int8(torch.Generator(device="cuda").manual_seed(0))
    fused = fuse_decode_params(params)
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, 128255, (BATCH, TEXT_LEN), generator=g, device="cuda")
    mask = torch.ones((BATCH, TEXT_LEN), dtype=torch.int32, device="cuda")

    def run(p, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = generate(p, cfg, ids, mask, gen, max_frames=MAX_FRAMES)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (int(res.n_frames.max()) + 1) * 1e3
        return res, step_ms, _build.launches()

    run(params, 1)
    run(fused, 1)  # warm-ups
    ms = {"unfused": [], "fused": []}
    fused_counts = None
    for name in ("unfused", "fused", "fused", "unfused"):
        res, step_ms, launches = run(fused if name == "fused" else params, 2)
        ms[name].append(step_ms)
        if not torch.isfinite(res.samples).all() or int(res.n_frames.min()) != MAX_FRAMES - 1:
            raise AssertionError(f"{name} generate: bad frames")
        if name == "fused":
            expect = {"qmm": 2 * L * MAX_FRAMES, "fused_mlp_gu": L * MAX_FRAMES,
                      "decode_attention": L * MAX_FRAMES, "fused_mlp": 0}
            for k, n in expect.items():
                if launches.get(k, 0) != n:
                    raise AssertionError(f"fused generate: {k} launched "
                                         f"{launches.get(k, 0)} times, the path implies {n}")
            fused_counts = {k: launches.get(k, 0) for k in expect}
    log(f"fused_decode ms_per_step fused {' / '.join(f'{x:.4f}' for x in ms['fused'])} "
        f"unfused {' / '.join(f'{x:.4f}' for x in ms['unfused'])} (batch {BATCH}, "
        f"{TEXT_LEN} text ids, {MAX_FRAMES} frames, prefill included; order unfused, fused, "
        f"fused, unfused) card {card}")
    log("  (c) fused generate launches " + json.dumps(fused_counts) + " (as the path implies)")

    lp, flp = layer_params(params["llama"]["layers"])[5], layer_params(fused["llama"]["layers"])[5]
    xg = torch.Generator(device="cuda").manual_seed(4)
    for M in (8, BATCH, 72):
        x = torch.randn(M, 2048, generator=xg, device="cuda").to(torch.bfloat16)
        if not torch.equal(fused_mlp(x, flp["wgu"], None, flp["wd"]),
                           fused_mlp(x, lp["wg"], lp["wu"], lp["wd"])):
            raise AssertionError(f"K3 fused mode M={M}: not bit-identical to the unfused K3")
    x = torch.randn(BATCH, 2048, generator=xg, device="cuda").to(torch.bfloat16)
    one = qmm(x, flp["wqkv"]["q"], flp["wqkv"]["scale"])
    three = torch.cat([qmm(x, lp[n]["q"], lp[n]["scale"]) for n in ("wq", "wk", "wv")], 1)
    e3 = _max_err(one, three)
    if not torch.allclose(one.float(), three.float(), atol=2e-2, rtol=2e-2):
        raise AssertionError(f"K2 on wqkv vs three launches: max abs err {e3:.4g}")
    log(f"  (c) K3 fused mode bit-identical to the unfused K3 at M 8/32/72 (flagship layer 5); "
        f"K2 on wqkv vs three launches max_abs_err {e3:.4g} (bf16, limit 2e-2)")

    scfg, sparams = small_f32_int8()
    sparams = tree_map(lambda t: t.to("cuda"), quantize_llama_params(sparams))
    sids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(2)).cuda()
    smask = torch.ones_like(sids)
    smask[1, :3] = 0
    a = generate(sparams, scfg, sids, smask, max_frames=16, greedy=True)
    b = generate(fuse_decode_params(sparams), scfg, sids, smask, max_frames=16, greedy=True)
    e_small = _max_err(a.means, b.means)
    if e_small > 1e-3 or not torch.equal(a.n_frames, b.n_frames):
        raise AssertionError(f"small f32 model: fused vs unfused frames {e_small:.4g}")
    log(f"  (c) small f32 model on the card, fused vs unfused greedy frames (16): max_abs_err "
        f"{e_small:.3g} (limit 1e-3)")

    # (d) the batcher on the fused params
    tok = build_tokenizer()
    prompts = [np.asarray(build_prompt_ids(tok, t))
               for t in serve_texts(16, np.random.default_rng(0))]
    cb = ContinuousBatcher(fused, cfg, batch_size=8, max_frames=SERVE_FRAMES,
                           prompt_buckets=SERVE_BUCKETS, seed=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    comps = cb.run(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches()
    if sorted(c.index for c in comps) != list(range(16)) or not all(
            c.n_frames == SERVE_FRAMES - 1 and np.isfinite(c.samples).all() for c in comps):
        raise AssertionError("the fused batcher lost a request or gave bad frames")
    steps = cb.step_count
    expect = {"decode_attention_sideband": L * steps, "qmm": 2 * L * steps,
              "fused_mlp_gu": L * steps, "fused_mlp": 0}
    for k, n in expect.items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"fused batcher: {k} launched {launches.get(k, 0)} times, "
                                 f"the path implies {n}")
    log(f"serve fused batch 8 requests 16 requests_per_s {16 / wall:.4f} ms_per_step "
        f"{wall / steps * 1e3:.4f} decode_steps {steps} card {card}")
    del cb
    kw = dict(batch_size=2, max_frames=8, prompt_buckets=(16,), greedy=True)
    sprompts = [np.random.default_rng(1).integers(1, 300, n).astype(np.int32) for n in (5, 11, 7)]
    ref = {c.index: c for c in ContinuousBatcher(sparams, scfg, **kw).run(sprompts)}
    got = {c.index: c for c in ContinuousBatcher(fuse_decode_params(sparams), scfg, **kw)
           .run(sprompts)}
    e_b = max(float(np.abs(got[i].means - ref[i].means).max()) for i in ref)
    if e_b > 1e-3 or any(got[i].n_frames != ref[i].n_frames for i in ref):
        raise AssertionError(f"small f32 model: fused vs unfused batcher {e_b:.4g}")
    log(f"  (d) launches " + json.dumps({k: launches.get(k, 0) for k in expect})
        + f" (as the path implies); small f32 fused vs unfused batcher max_abs_err {e_b:.3g} "
          "(limit 1e-3)")
    del params, fused
    torch.cuda.empty_cache()
    return fused_counts


def closure_int4(card: str) -> None:
    """(e) int4 (group 128) at full width: 16 frames at batch 32 through
    generate beside int8; the group-wise matmuls take the plain route
    (ops.quant.qmatmul: no kernel takes group-wise scales), attention K1.
    The small f32 model with int4 weights on the card against the CPU
    (1e-3)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    cfg = flagship_cfg()
    L = cfg.llama.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    int4 = quantize_llama_params(llasa.init_params(cfg, g, "cuda"), bits=4, group=128)
    int8 = flagship_int8(torch.Generator(device="cuda").manual_seed(0))
    ids = torch.randint(0, 128255, (BATCH, TEXT_LEN),
                        generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    mask = torch.ones((BATCH, TEXT_LEN), dtype=torch.int32, device="cuda")
    ms = {}
    for name, p in (("int4", int4), ("int8", int8), ("int4", int4), ("int8", int8)):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = generate(p, cfg, ids, mask, torch.Generator(device="cuda").manual_seed(2),
                       max_frames=INT4_FRAMES)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / INT4_FRAMES * 1e3  # the second run's
        launches = _build.launches()
        if not torch.isfinite(res.samples).all():
            raise AssertionError(f"{name} generate: non-finite frames")
        if name == "int4" and (launches.get("qmm", 0) or launches.get("fused_mlp", 0)
                               or launches.get("decode_attention", 0) != L * INT4_FRAMES):
            raise AssertionError(f"int4 generate launches {launches}: the group-wise "
                                 "matmuls must take the plain route, attention K1")
    log(f"int4 ms_per_step {ms['int4']:.4f} (route: plain group-wise qmatmul, f32 einsum; "
        f"K1 attention) int8 ms_per_step {ms['int8']:.4f} (K2/K3) (batch {BATCH}, "
        f"{INT4_FRAMES} frames, prefill included; int4 values stored a byte each) card {card}")
    del int4, int8
    torch.cuda.empty_cache()
    scfg, sparams = small_f32_int8()
    sparams = quantize_llama_params(sparams, bits=4, group=128)
    sids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(2))
    smask = torch.ones_like(sids)
    smask[1, :3] = 0
    out = {dev: generate(tree_map(lambda t: t.to(dev), sparams), scfg, sids.to(dev),
                         smask.to(dev), max_frames=8, greedy=True) for dev in ("cpu", "cuda")}
    err = _max_err(out["cuda"].means.cpu(), out["cpu"].means)
    if err > 1e-3 or not torch.equal(out["cuda"].n_frames.cpu(), out["cpu"].n_frames):
        raise AssertionError(f"small int4 model: card vs CPU {err:.4g}")
    log(f"  (e) small f32 model with int4 weights, card vs CPU greedy frames max_abs_err "
        f"{err:.3g} (limit 1e-3)")


# --------------------------------------------------------------- phase 8 ----

# (a)/(b): texts and frames; (c): text ids and frames; (d): batch, text ids
# and steps; the reference voice's seconds and rate (phase 6's)
CODEC_ROWS, CODEC_FRAMES = 8, 128
CFG_TEXT, CFG_FRAMES = 32, 128
STREAM_B, STREAM_TEXT, STREAM_STEPS = 8, 32, 128
K1_K3 = ("decode_attention", "qmm", "fused_mlp")


def with_heads(backbone: dict, cfg, g, dev="cuda", ecapa_cfg=None) -> dict:
    """`backbone` (a llama param tree) under heads drawn from `g`: llasa's
    MLP head when `ecapa_cfg` is None, else the variants' Linear head, its
    audio_linear, the speaker VAE's linear and ECAPA at `ecapa_cfg` (f32).
    The heads are initialised under a one-layer stand-in backbone, which is
    thrown away."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, torch_dtype
    from kalle_tpu_torch.models.lm import llasa, variants

    stand_in = dataclasses.replace(cfg, llama=LlamaConfig(
        vocab_size=8, hidden_size=64, intermediate_size=64, num_layers=1, num_heads=1,
        num_kv_heads=1, head_dim=64))
    if ecapa_cfg is None:
        params = llasa.init_params(stand_in, g, dev)
    else:
        params = variants.init_variant_params(stand_in, g, ecapa_cfg, speaker_vae=True,
                                              device=dev)
    dt = torch_dtype(cfg.llama.dtype)
    for name in ("audio_linear", "distribution_linear"):
        params[name] = tree_map(lambda t: t.to(dt), params[name])
    params["llama"] = backbone
    return params


def encoded_frames(kind: str, cfg, t: int) -> int:
    """Frames the JAX package's encoder gives for t samples: each strided
    conv of kernel 2s gives (t + 2 pad - 2s) // s + 1 (Oobleck pads
    ceil(s/2), the mel-VAE (2s-1)//2); the other convs keep the length."""
    if kind == "stableaudio":
        for s in cfg.strides:
            t = (t + 2 * math.ceil(s / 2) - 2 * s) // s + 1
    else:
        for f in cfg.downsample_rates:
            t = (t + 2 * ((2 * f - 1) // 2) - 2 * f) // f + 1
    return t


def reference_voice(sr: int, seconds: int, channels: int, rng) -> np.ndarray:
    """A synthetic voice-like reference (1, channels, seconds * sr) f32."""
    t = np.arange(seconds * sr) / sr
    x = np.sin(2 * np.pi * 180 * t) * (0.3 + 0.2 * np.sin(3 * t)) + rng.normal(0, 0.01, t.size)
    return np.repeat(x[None, None].astype(np.float32), channels, axis=1)


def _counted(fn):
    """fn() with the launch counts set to 0 just before; (result, counts)."""
    from kalle_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    out = fn()
    return out, _build.launches()


def p8_codec(card: str, kind: str, backbone: dict, texts: list, g, dev="cuda",
             lm_cfg=None, codec_cfg=None):
    """(a)/(b): InferTools.synthesize_batch of `texts` through the
    stableaudio or melvae codec (bf16; melvae with flow_reverse), then a
    4 s clip through encode_audio. Returns (the LM's cfg and params, the
    launches of the counted run)."""
    from kalle_tpu_torch.data.tokens import ByteTokenizer, build_prompt_ids
    from kalle_tpu_torch.infer import pipeline
    from kalle_tpu_torch.infer.pipeline import Codec, InferTools
    from kalle_tpu_torch.models.codecs import melvae

    stable = kind == "stableaudio"
    cfg = lm_cfg or (dataclasses.replace(flagship_cfg(), head_variant="stableaudio") if stable else
                     dataclasses.replace(flagship_cfg(), latent_dim=512, head_variant="melvae"))
    params = with_heads(backbone, cfg, g, dev)
    codec = Codec.random_init(kind, g, dev, **({"cfg": codec_cfg} if codec_cfg else {}))
    if not stable:
        # the flow's couplings start at the identity (post = 0): give them
        # weights, then check forward then reverse on the card in f32
        for f in codec.params["flows"]:
            f["post"]["w"] = 0.02 * torch.randn(f["post"]["w"].shape, generator=g, device=dev)
        z = torch.randn(2, codec.cfg.latent_dim, 50, generator=g, device=dev)
        fwd = melvae.flow(codec.params, codec.cfg, z)
        err = _max_err(melvae.flow(codec.params, codec.cfg, fwd, reverse=True), z)
        moved = _max_err(fwd, z)
        log(f"  melvae flow on the card (f32): reverse(forward(z)) max_abs_err {err:.3g} "
            f"(limit 1e-4; forward moved z by {moved:.3g})")
        if err > 1e-4 or moved < 1e-3:
            raise AssertionError("the mel-VAE flow does not invert on the card")
    codec.astype(torch.bfloat16)
    spf, sr = codec.samples_per_frame, codec.sample_rate
    channels = 2 if stable else 1
    with tempfile.TemporaryDirectory() as root:  # InferTools makes its output dir
        it = InferTools(cfg, params, ByteTokenizer(), codec, output_root=root,
                        version=f"phase8{kind}", timestamp=False, flow_reverse=not stable)

    results, codec_s = [], [0.0]
    real_generate, real_decode = pipeline.generate, codec.decode_latents

    def spy_generate(*a, **kw):
        results.append(real_generate(*a, **kw))
        return results[-1]

    def timed_decode(*a, **kw):
        t0 = time.perf_counter()
        out = real_decode(*a, **kw)  # ends in a host copy: synchronised
        codec_s[0] += time.perf_counter() - t0
        return out

    pipeline.generate, codec.decode_latents = spy_generate, timed_decode
    try:
        for run in range(2):  # the first warms this batch's shapes
            results.clear()
            codec_s[0] = 0.0
            t0 = time.perf_counter()
            wavs, counts = _counted(lambda: it.synthesize_batch(
                texts, max_frames=CODEC_FRAMES, batch_size=len(texts)))
            wall = time.perf_counter() - t0
    finally:
        pipeline.generate = real_generate
        codec.decode_latents = real_decode
    res = results[0]
    n_frames = res.n_frames.cpu()
    steps = int(n_frames.max()) + 1
    L = cfg.llama.num_layers
    check_launches(f"{kind} synthesize_batch", counts,
                   {"decode_attention": L * steps, "qmm": 4 * L * steps, "fused_mlp": L * steps})
    ids = [build_prompt_ids(it.tokenizer, t) for t in texts]
    order = sorted(range(len(texts)), key=lambda i: len(ids[i]))
    for r, i in enumerate(order):
        want = (channels, max(int(n_frames[r]), 1) * spf)
        w = wavs[i]
        if w.shape != want or not np.isfinite(w).all() or np.abs(w).max() > 1.0:
            raise AssertionError(f"{kind} wav {i}: {w.shape} (want {want}), "
                                 f"max |x| {np.abs(w).max():.3g}")
    audio_s = sum(w.shape[-1] for w in wavs) / sr
    log(f"{kind} synthesize_batch rows {len(texts)} wall_s {wall:.4f} rtf {wall / audio_s:.6g} "
        f"audio_s {audio_s:.2f} codec_ms {codec_s[0] * 1e3:.3f} steps {steps} "
        f"n_frames {sorted(set(n_frames.tolist()))} (second run; sr {sr}, {channels} ch, "
        f"{spf} samples a frame) card {card}")

    clip = reference_voice(sr, PROMPT_S, channels, np.random.default_rng(8))
    codec.encode_audio(clip)  # warm-up
    t0 = time.perf_counter()
    for _ in range(ITERS):
        z = codec.encode_audio(clip)
    enc_ms = (time.perf_counter() - t0) / ITERS * 1e3
    want = (1, 2 * codec.cfg.latent_dim, encoded_frames(kind, codec.cfg, clip.shape[-1]))
    if z.shape != want or not np.isfinite(z).all():
        raise AssertionError(f"{kind} encode_audio gave {z.shape}, want {want}")
    log(f"{kind} encode_audio {PROMPT_S} s clip ({sr} Hz, {channels} ch, bf16): ms {enc_ms:.3f} "
        f"shape {z.shape} (host clock, H2D and D2H included) card {card}")
    if dev == "cuda":
        lat = it._latents_for_decode(res, slice(0, CODEC_FRAMES))
        with_profile(lambda: codec.decode_latents(lat, flow_reverse=not stable),
                     f"the {kind} decode of {len(texts)} x {CODEC_FRAMES} frames")
    return cfg, params, counts


def p8_cfg(card: str, cfg, params: dict, g, dev="cuda", frames=CFG_FRAMES):
    """(c) cfg_generate v1 and v2 at batch 1: every frame runs (threshold
    0), two branches a step. Returns the counted runs' launches."""
    from kalle_tpu_torch.infer.cfg import cfg_generate

    ids = torch.randint(0, 128255 if dev == "cuda" else cfg.llama.vocab_size, (1, CFG_TEXT),
                        generator=g, device=dev)
    L = cfg.llama.num_layers
    total: dict = {}
    for variant in ("v1", "v2"):
        cfg_generate(params, cfg, ids, g, max_frames=8, cfg_variant=variant,
                     end_kl_threshold=0.0)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        res, counts = _counted(lambda: cfg_generate(params, cfg, ids, g, max_frames=frames,
                                                    cfg_variant=variant, end_kl_threshold=0.0))
        sync(dev)
        ms = (time.perf_counter() - t0) / frames * 1e3
        check_launches(f"cfg_generate {variant}", counts,
                       {"decode_attention": 2 * L * frames, "qmm": 2 * 4 * L * frames,
                        "fused_mlp": 2 * L * frames})
        if int(res.n_frames[0]) != frames - 1 or not torch.isfinite(res.samples).all():
            raise AssertionError(f"cfg_generate {variant}: n_frames {res.n_frames.tolist()}")
        log(f"cfg_generate {variant} batch 1 text {CFG_TEXT} frames {frames} ms_per_step "
            f"{ms:.4f} (two branches a step, prefills included) card {card}")
        _add(total, counts)
    if dev == "cuda":
        with_profile(lambda: cfg_generate(params, cfg, ids, g, max_frames=32,
                                          end_kl_threshold=0.0), "cfg_generate v1, 32 frames")
    return total


def p8_stream(card: str, backbone: dict, g, dev="cuda", lm_cfg=None, codec_cfg=None,
              ecapa_cfg=None, steps=STREAM_STEPS):
    """(d) streaming with the speaker VAE at melvae_dim2048_tts_sft's shape:
    a 4 s 16 kHz reference -> mel -> 200 frames -> ECAPA -> a sampled
    speaker frame; warm-up latents from one frame of silence through the
    mel-VAE's encoder; stream_generate at batch STREAM_B, then the decode.
    Returns the counted run's launches."""
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.infer.streaming import (sample_speaker_cond, stream_generate,
                                                 warmup_latents_from_silence)
    from kalle_tpu_torch.models.conditioning.ecapa import EcapaConfig
    from kalle_tpu_torch.models.lm.variants import speaker_embedding
    from kalle_tpu_torch.ops.mel import mel_spectrogram, modify_vector

    cfg = lm_cfg or dataclasses.replace(flagship_cfg(), latent_dim=1024, head_variant="melvae")
    ecapa_cfg = ecapa_cfg or EcapaConfig()
    params = with_heads(backbone, cfg, g, dev, ecapa_cfg=ecapa_cfg)
    codec = Codec.random_init("melvae", g, dev,
                              **({"cfg": codec_cfg} if codec_cfg else {"latent_dim": 1024}))
    codec.astype(torch.bfloat16)
    d, h, sr = cfg.latent_dim, cfg.audio_proj_dim, codec.sample_rate
    ref = torch.from_numpy(reference_voice(sr, PROMPT_S, 1, np.random.default_rng(9))[0]).to(dev)
    mel = modify_vector(mel_spectrogram(ref, sample_rate=sr), 200)  # (1, 80, 200)
    speaker_embedding(params, ecapa_cfg, mel)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        spk = speaker_embedding(params, ecapa_cfg, mel)
    sync(dev)
    ecapa_ms = (time.perf_counter() - t0) / ITERS * 1e3
    cond = sample_speaker_cond(params, g, h, spk).expand(STREAM_B, h)
    hop_hz = sr / codec.samples_per_frame
    warm = warmup_latents_from_silence(codec.encode_audio, 1, sr, hop_hz, batch=STREAM_B,
                                       device=dev)  # (b, 2d, 1) mean||logs
    prompt = torch.from_numpy(warm[:, :d]).transpose(1, 2).to(dev)  # the means, (b, 1, d)
    ids = torch.randint(0, 128255 if dev == "cuda" else cfg.llama.vocab_size,
                        (STREAM_B, STREAM_TEXT), generator=g, device=dev)
    stream_generate(params, cfg, ids, prompt, cond, g, max_steps=8, end_kl_threshold=0.0)
    sync(dev)
    t0 = time.perf_counter()
    res, counts = _counted(lambda: stream_generate(params, cfg, ids, prompt, cond, g,
                                                   max_steps=steps, end_kl_threshold=0.0))
    sync(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    L = cfg.llama.num_layers
    check_launches("stream_generate", counts, {"decode_attention": L * steps,
                                               "qmm": 4 * L * steps, "fused_mlp": L * steps})
    t0 = time.perf_counter()
    wav = codec.decode_latents(res.samples)
    dec_ms = (time.perf_counter() - t0) * 1e3
    want = (STREAM_B, 1, steps * codec.samples_per_frame)
    if (tuple(res.n_frames.tolist()) != (steps - 1,) * STREAM_B or wav.shape != want
            or not np.isfinite(wav).all() or tuple(cond.shape) != (STREAM_B, h)):
        raise AssertionError(f"streaming: n_frames {res.n_frames.tolist()}, wav {wav.shape}")
    log(f"stream_generate batch {STREAM_B} text {STREAM_TEXT} steps {steps} ms_per_step "
        f"{ms:.4f} (prefill included) ecapa_ms {ecapa_ms:.3f} (batch 1, 200 frames) "
        f"codec_decode_ms {dec_ms:.3f} card {card}")
    if dev == "cuda":
        with_profile(lambda: stream_generate(params, cfg, ids, prompt, cond, g, max_steps=32,
                                             end_kl_threshold=0.0),
                     f"stream_generate, batch {STREAM_B}, 32 steps")
    return counts


def p8_variant_forward(card: str, g, dev="cuda", cfg=None, ecapa_cfg=None, t=TRAIN_T,
                       b=TRAIN_B, mrte_cfg=None):
    """(e) stream_spkvae_forward and its gradient at phase 4's shape (f32
    params, bf16 compute, flash on), then one MRTE forward. Returns the
    counted run's launches."""
    from kalle_tpu_torch.bridge import tree_leaves
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.models.conditioning import mrte
    from kalle_tpu_torch.models.conditioning.ecapa import EcapaConfig
    from kalle_tpu_torch.models.lm import variants
    from kalle_tpu_torch.ops.mel import mel_spectrogram

    cfg = cfg or LlasaConfig(llama=LlamaConfig(use_flash_attention=True), latent_dim=1024,
                             audio_proj_dim=2048, head_variant="melvae")
    ecapa_cfg = ecapa_cfg or EcapaConfig()
    params = variants.init_variant_params(cfg, g, ecapa_cfg, speaker_vae=True, device=dev)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    d, n = cfg.latent_dim, t - 1  # the speaker frame makes t
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    bos_mask = torch.zeros(b, n, dtype=torch.bool, device=dev)
    bos_mask[:, 0] = True
    end = torch.zeros(b, n, dtype=torch.bool, device=dev)
    end[:, -1] = True
    batch = {"input_ids": torch.randint(0, cfg.llama.vocab_size, (b, n), generator=g, device=dev),
             "audio_latents": r(b, n, d), "distribute_labels": torch.cat([r(b, n, d),
                                                                          0.1 * r(b, n, d) - 1], -1),
             "bos_token": torch.full((b, 1), 7, device=dev), "bos_mask": bos_mask,
             "attention_mask": torch.ones(b, n, dtype=torch.int32, device=dev),
             "target_mask": ~end, "end_mask": end, "mels": r(b, ecapa_cfg.in_channels, 200)}

    def step():
        out = variants.stream_spkvae_forward(params, cfg, batch, ecapa_cfg, g)
        loss = out["audio_loss"] + 0.2 * out["end_loss"] + 0.1 * out["speaker_cond_kl"]
        loss.backward()
        return out, loss

    sync(dev)
    t0 = time.perf_counter()
    (out, loss), counts = _counted(step)
    sync(dev)
    wall = time.perf_counter() - t0
    L = cfg.llama.num_layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if dev == "cuda" and counts.get(name, 0) != L:
            raise AssertionError(f"stream_spkvae_forward: {name} {counts.get(name, 0)} "
                                 f"launches, the path implies {L}")
    grads_ok = all(x.grad is not None and bool(torch.isfinite(x.grad).all())
                   for x in leaves if x.is_floating_point())
    if not (torch.isfinite(loss) and grads_ok):
        raise AssertionError(f"stream_spkvae_forward: loss {float(loss)}, grads finite {grads_ok}")
    log(f"  (e) stream_spkvae_forward + backward batch {b} x {t} (f32 params, bf16, flash): "
        f"s {wall:.3f} (first call) loss {float(loss.detach()):.4g} speaker_cond_kl "
        f"{float(out['speaker_cond_kl'].detach()):.4g}; launches "
        + json.dumps({k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}))
    del params, leaves, batch, out, loss
    if dev == "cuda":
        torch.cuda.empty_cache()

    mcfg = mrte_cfg or mrte.MRTEConfig()
    mp = mrte.init_params(mcfg, g, dev)
    ref = torch.from_numpy(reference_voice(16000, PROMPT_S, 1, np.random.default_rng(9))[0])
    mel = mel_spectrogram(ref.to(dev))[:, :mcfg.mel_bins]  # (1, 80, frames)
    with torch.no_grad():
        cond, tc = mrte.forward(mp, mcfg, mel, r(1, 32, mcfg.hidden_size))
    if (tuple(cond.shape) != (1, 2048) or tuple(tc.shape) != (1, 32, mcfg.hidden_size)
            or not (torch.isfinite(cond).all() and torch.isfinite(tc).all())):
        raise AssertionError(f"mrte.forward: {tuple(cond.shape)} {tuple(tc.shape)}")
    log(f"  (e) mrte.forward at MRTEConfig() on a {mel.shape[-1]}-frame mel and 32 phone "
        f"frames: mel_cond {tuple(cond.shape)} tc {tuple(tc.shape)}, finite")
    del mp
    return counts


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def p8_small_reference():
    """(f) Small f32 models on the card (TF32 off) against the port's CPU
    path: a tiny Oobleck and MelVAEConfig.tiny() (encode, decode, both flow
    directions), a tiny ECAPA and MRTE, and cfg_generate v1/v2 and
    stream_generate of a tiny int8 model with the same injected noise."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.infer.cfg import cfg_generate
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.infer.streaming import stream_generate
    from kalle_tpu_torch.models.codecs import melvae, oobleck
    from kalle_tpu_torch.models.conditioning import ecapa, mrte
    from kalle_tpu_torch.models.lm import llasa, variants
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    g = torch.Generator().manual_seed(10)
    rnd = lambda *s: torch.randn(s, generator=g)
    oob = oobleck.OobleckConfig(channels=8, latent_dim=8, encoder_out_dim=16, c_mults=(1, 2, 4),
                                strides=(2, 4, 4))
    mcfg = melvae.MelVAEConfig.tiny()
    codecs = {"stableaudio": Codec.random_init("stableaudio", g, "cpu", cfg=oob),
              "melvae": Codec.random_init("melvae", g, "cpu", cfg=mcfg)}
    for f in codecs["melvae"].params["flows"]:
        f["post"]["w"] = 0.1 * rnd(*f["post"]["w"].shape)
    ecfg, rcfg = ecapa.EcapaConfig.tiny(), mrte.MRTEConfig.tiny()
    ep = ecapa.init_params(ecfg, g, "cpu")
    rp = mrte.init_params(rcfg, g, "cpu")
    llama = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, dtype="float32")
    cfg = LlasaConfig(llama=llama, latent_dim=16, audio_proj_dim=256, head_variant="melvae")
    lp = quantize_llama_params(llasa.init_params(cfg, g, "cpu"))
    vp = dict(lp, **{k: v for k, v in variants.init_variant_params(
        dataclasses.replace(cfg, llama=LlamaConfig.tiny()), g, ecfg, device="cpu").items()
        if k in ("audio_linear", "distribution_linear")})
    inputs = {"wav2": 0.3 * rnd(2, 2, 40 * oob.downsampling_ratio),
              "wav1": 0.3 * rnd(2, 1, 40 * mcfg.hop), "lat": rnd(2, 12, 8),
              "mel": rnd(2, 30, ecfg.in_channels), "rmel": rnd(2, rcfg.mel_bins, 41),
              "phone": rnd(2, 7, rcfg.hidden_size), "ids": torch.randint(0, 300, (1, 9), generator=g),
              "sids": torch.randint(0, 300, (3, 11), generator=g), "warm": rnd(3, 2, 16),
              "spk": rnd(3, 256), "noise": rnd(3, 8, 16)}
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda tree: tree_map(lambda t: t.to(dev), tree)
        x = mv(inputs)
        sa = Codec("stableaudio", oob, mv(codecs["stableaudio"].params))
        mc = Codec("melvae", mcfg, mv(codecs["melvae"].params))
        z = x["lat"].transpose(1, 2)
        o = {"oobleck encode": sa.encode_audio(x["wav2"]),
             "oobleck decode": sa.decode_latents(x["lat"]),
             "melvae encode": mc.encode_audio(x["wav1"]),
             "melvae decode": mc.decode_latents(x["lat"]),
             "melvae flow": melvae.flow(mc.params, mcfg, z),
             "melvae flow reverse": melvae.flow(mc.params, mcfg, z, reverse=True),
             "ecapa": ecapa.forward(mv(ep), ecfg, x["mel"])}
        with torch.no_grad():
            o["mrte cond"], o["mrte tc"] = mrte.forward(mv(rp), rcfg, x["rmel"], x["phone"])
        for v in ("v1", "v2"):
            res = cfg_generate(mv(lp), cfg, x["ids"], max_frames=8, cfg_variant=v,
                               end_kl_threshold=0.0, noise=x["noise"][:1])
            o[f"cfg {v}"] = res.samples
        res = stream_generate(mv(vp), cfg, x["sids"], x["warm"], x["spk"], max_steps=8,
                              end_kl_threshold=0.0, noise=x["noise"])
        o["stream"] = res.samples
        out[dev] = {k: torch.as_tensor(v).cpu().float() for k, v in o.items()}
    errs = {k: _max_err(out["cuda"][k], out["cpu"][k]) / max(1.0, float(out["cpu"][k].abs().max()))
            for k in out["cpu"]}
    log("  (f) small f32 models, card vs CPU, max_abs_err / max(1, max |ref|): "
        + " ".join(f"{k} {e:.3g}" for k, e in errs.items()) + " (limit 1e-3)")
    bad = [k for k, e in errs.items() if not e <= 1e-3]
    if bad:
        raise AssertionError(f"card disagrees with the CPU path: {bad}")


def phase_codecs(card: str) -> dict:
    """Phase 8: the Oobleck and mel-VAE codecs through InferTools, CFG and
    streaming generation, the variant forward and MRTE at full width, and
    small f32 models card vs CPU. Returns the launches of its counted
    runs."""
    log("# phase 8: stableaudio and melvae codecs, CFG, streaming, variants, conditioning")
    counts: dict = {}
    g = torch.Generator(device="cuda").manual_seed(8)
    backbone = flagship_int8(torch.Generator(device="cuda").manual_seed(0))["llama"]  # phase 3's
    texts = serve_texts(CODEC_ROWS, np.random.default_rng(8))
    cfg_a, params_a, c = p8_codec(card, "stableaudio", backbone, texts, g)
    _add(counts, c)
    torch.cuda.empty_cache()
    _add(counts, p8_codec(card, "melvae", backbone, texts, g)[2])
    torch.cuda.empty_cache()
    _add(counts, p8_cfg(card, cfg_a, params_a, g))
    del params_a
    _add(counts, p8_stream(card, backbone, g))
    del backbone
    torch.cuda.empty_cache()
    _add(counts, p8_variant_forward(card, g))
    torch.cuda.empty_cache()
    p8_small_reference()
    return counts


# --------------------------------------------------------------- phase 9 ----

# (a) the codec trainer at each codec's default config: batch and clip samples
P9_KINDS = {"sigma": (4, 48000), "melvae": (4, 40960), "oobleck": (2, 65536)}
P9_LR = 1e-4  # make_codec_optimizer's default
P9_GAN_STEPS = 4
# (d) the eval models' training steps (cut from the JAX defaults of 600 and 500)
P9_ASR_STEPS, P9_SPK_STEPS = 100, 100
P9_SCORE_ROWS = 8
# (b) the share of elements with a gradient that only the AdamW rule holds
P9_BELOW_MAX = 0.05


def p9_codec(kind: str, size: str, g, dev="cuda"):
    """-> (codec cfg, gen params, discriminator cfg, loss weights, adv type)
    of `kind` at `size` ("full": the default configs; "small": the demo's
    and the tiny ones), f32 on `dev`."""
    from kalle_tpu_torch.models.codecs import discriminators as disc
    from kalle_tpu_torch.models.codecs import melvae, oobleck, sigmavae
    from kalle_tpu_torch.train import codec_trainer as ct

    full = size == "full"
    if kind == "sigma":
        cfg = sigmavae.SigmaVAEConfig() if full else sigmavae.SigmaVAEConfig(
            latent_dim=16, strides=(2, 2), channels=(16, 32), blocks_per_stage=1)
        return (cfg, sigmavae.init_params(cfg, g, dev),
                disc.DiscriminatorConfig() if full else disc.DiscriminatorConfig.tiny(),
                ct.LossWeights(), "lsgan")
    if kind == "melvae":
        cfg = melvae.MelVAEConfig() if full else melvae.MelVAEConfig.tiny()
        return (cfg, melvae.init_params(cfg, g, dev),
                disc.DiscriminatorConfig() if full else disc.DiscriminatorConfig.tiny(),
                ct.LossWeights(), "lsgan")
    cfg = oobleck.OobleckConfig() if full else oobleck.OobleckConfig(
        channels=8, latent_dim=8, encoder_out_dim=16, c_mults=(1, 2), strides=(2, 4),
        sample_rate=16000)
    return (cfg, oobleck.init_params(cfg, g, dev),
            disc.DiscriminatorConfig.encodec_stereo() if full
            else disc.DiscriminatorConfig.tiny(2), ct.LossWeights.oobleck_default(), "hinge")


def p9_clips(kind: str, cfg, batch: int, samples: int, seed: int) -> np.ndarray:
    """(batch, channels, samples) f32 of rendered synthetic speech at the
    codec's rate (each row a random sentence by another speaker, tiled to
    length); the Oobleck's right channel is the left delayed 0.5 ms."""
    from kalle_tpu_torch.data import synth_speech as sl

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(batch):
        w = sl.render(sl.random_sentence(rng, (4, 8)), cfg.sample_rate, speaker=i, seed=seed)
        rows.append(np.resize(w, samples))
    x = np.stack(rows).astype(np.float32)
    if kind == "oobleck":
        return np.stack([x, 0.9 * np.roll(x, cfg.sample_rate // 2000, axis=-1)], 1)
    return x[:, None]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _moved(a: dict, b: dict) -> float:
    from kalle_tpu_torch.bridge import tree_leaves

    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _copy(tree):
    from kalle_tpu_torch.bridge import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def p9_trainer(card: str, kind: str, root: str) -> None:
    """(a) one recon-only generator step (the mel-VAE's with its encoder
    frozen), then P9_GAN_STEPS with the GAN on from step 1, the
    discriminator before the generator on odd steps; the sigma codec with
    an EMA and a latent mask of 0.1. f32 at the default config."""
    from torch.profiler import ProfilerActivity, profile

    from kalle_tpu_torch.models.codecs import discriminators as disc
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.train import codec_trainer as ct

    batch, samples = P9_KINDS[kind]
    g = torch.Generator(device="cuda").manual_seed(90)
    torch.cuda.reset_peak_memory_stats()
    cfg, gen, dcfg, weights, adv = p9_codec(kind, "full", g)
    dp = disc.init_params(dcfg, g, "cuda")
    tx = ct.make_codec_optimizer(P9_LR)
    state = ct.make_state(gen, dp, tx, tx, use_ema=kind == "sigma")
    gen0, dp0 = _copy(gen), _copy(dp)
    wav = torch.from_numpy(p9_clips(kind, cfg, batch, samples, 9)).cuda()
    kw = dict(warmup_steps=1, adv_type=adv, latent_mask_ratio=0.1 if kind == "sigma" else 0.0)
    _build.reset_launches()
    _, m = ct.generator_step(state, kind, cfg, dcfg, weights, wav, g, gan_on=False,
                             freeze_encoder=kind == "melvae", **kw)
    metrics = [m]
    if kind == "melvae" and _moved(state.gen_params["encoder"], gen0["encoder"]) != 0.0:
        raise AssertionError("melvae: the frozen encoder's weights moved")
    gen_ms, disc_ms = [], []
    for i in range(1, 1 + P9_GAN_STEPS):
        if i % 2:
            (_, dm), ms = _timed(lambda: ct.discriminator_step(state, kind, cfg, dcfg, wav, g,
                                                               adv_type=adv))
            metrics.append(dm)
            disc_ms.append(ms)
        (_, m), ms = _timed(lambda: ct.generator_step(state, kind, cfg, dcfg, weights, wav, g,
                                                      **kw))
        metrics.append(m)
        gen_ms.append(ms)
    counts = _build.launches()
    bad = [k for m in metrics for k, v in m.items() if not bool(torch.isfinite(v))]
    if bad:
        raise AssertionError(f"{kind}: non-finite losses {bad}")
    if any(counts.values()):
        raise AssertionError(f"{kind}: codec training launched kernels {counts}")
    moved_g, moved_d = _moved(state.gen_params, gen0), _moved(state.disc_params, dp0)
    if not (moved_g > 0 and moved_d > 0):
        raise AssertionError(f"{kind}: weights did not move (gen {moved_g}, disc {moved_d})")
    if state.gen_ema is not None and _moved(state.gen_ema, state.gen_params) == 0.0:
        raise AssertionError("sigma: the EMA equals the weights")
    peak = torch.cuda.max_memory_allocated() / 1e9
    last, last_d = metrics[-1], [m for m in metrics if "adv_d" in m][-1]
    log(f"codec_train {kind} batch {batch} samples {samples} gen_step_ms "
        f"{np.mean(gen_ms[1:]):.2f} disc_step_ms {disc_ms[-1]:.2f} (host clock, after a "
        f"warm-up step) peak_mem_gb {peak:.2f} gen_total {float(last['gen_total']):.4f} "
        f"adv_g {float(last['adv_g']):.4f} fm {float(last['fm']):.4f} adv_d "
        f"{float(last_d['adv_d']):.4f} launches {json.dumps(counts)} card {card}")
    log(f"  {kind}: losses finite, gen moved {moved_g:.3g}, disc moved {moved_d:.3g}"
        + (", frozen encoder unmoved" if kind == "melvae" else "")
        + (", EMA differs from the weights" if state.gen_ema is not None else ""))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = _timed(lambda: ct.generator_step(state, kind, cfg, dcfg, weights, wav, g, **kw))
    report_profile(prof, ms / 1e3, f"one {kind} GAN generator step")
    if kind == "sigma":
        from kalle_tpu_torch.core.checkpoint import CheckpointManager

        mgr = CheckpointManager(os.path.join(root, "codec"))
        mgr.save(state.step, state, wait=True)
        tmpl = ct.make_state(p9_codec(kind, "full", g)[1], disc.init_params(dcfg, g, "cuda"),
                             tx, tx, use_ema=True)
        restored, step = mgr.restore(tmpl)
        a, b = state.state_dict(), restored.state_dict()
        same = (step == state.step == restored.step
                and all(_leaves_equal(a[k], b[k])
                        for k in ("gen_params", "disc_params", "gen_ema"))
                and all(_leaves_equal([v for s in a[o]["state"].values() for v in s.values()],
                                      [v for s in b[o]["state"].values() for v in s.values()])
                        for o in ("gen_opt", "disc_opt")))
        if not same:
            raise AssertionError("the restored CodecTrainState differs")
        log(f"  sigma: CodecTrainState checkpoint (step {step}) restores leaf for leaf "
            "bit-equal, both optimizer states included")
    del state, gen, dp, gen0, dp0
    torch.cuda.empty_cache()


def _adam_first_step(p_card, p_cpu, p0, g_card, g_cpu, g64, lr: float, wd: float) -> dict:
    """Holds one AdamW update of the same params made on the card and on the
    CPU in f32, element by element, against the gradient `g64` of a float64
    run on the CPU, which stands for the exact one. Per leaf, with e_cpu and
    e_card the two f32 gradients' largest distance from it and s its
    largest |g64|:
    - grad: e_card <= 2·e_cpu + 1e-5·s. The card's f32 gradient is as near
      the exact one as the CPU's. (A log-magnitude STFT loss divides by
      each bin's magnitude, so f32 rounding of the quiet bins reaches its
      gradient at ~1e-2 of the largest, on either device.)
    - rule: in each run every element moved as AdamW's first step says on
      that run's own gradient, -lr·(wd·p0 + g/(|g| + 1e-8)).
    - param: the two runs agree wherever |g64| is above twice both f32
      gradients' distance from it at that element, above 1e-5·s and above
      100 times Adam's eps: both runs' gradients have its sign there, and
      Adam's step does not depend on their size. Elsewhere Adam turns f32
      rounding into a share of lr, and the rule (on a gradient that the
      grad check holds) alone holds the element; `below` is their share
      among the elements with a gradient.
    Returns the worst grad ratio (e_card over its bound), rule and param
    errors over lr, and `below`."""
    out = {"grad": 0.0, "rule": 0.0, "param": 0.0, "below": 0, "n": 0}
    for a, b, a0, ga, gb, g in zip(p_card, p_cpu, p0, g_card, g_cpu, g64):
        a, b, a0, ga, gb, g = (t.detach().cpu().double() for t in (a, b, a0, ga, gb, g))
        s = float(g.abs().max())
        e_card, e_cpu = float((ga - g).abs().max()), float((gb - g).abs().max())
        bound = 2 * e_cpu + 1e-5 * s
        if e_card:
            out["grad"] = max(out["grad"], e_card / bound if bound else math.inf)
        for x, gx in ((a, ga), (b, gb)):
            rule = x - a0 * (1 - lr * wd) + lr * gx / (gx.abs() + 1e-8)
            out["rule"] = max(out["rule"], float(rule.abs().max()) / lr)
        live = ((g.abs() > 2 * torch.maximum((ga - g).abs(), (gb - g).abs()) + 1e-5 * s)
                & (g.abs() > 1e-6))
        if live.any():
            out["param"] = max(out["param"], float((a - b)[live].abs().max()) / lr)
        has_grad = (ga != 0) | (gb != 0)
        out["below"] += int((~live & has_grad).sum())
        out["n"] += int(has_grad.sum())
    out["below"] /= max(out["n"], 1)
    return out


def p9_small_reference() -> None:
    """(b) one generator step (GAN on) and one discriminator step of each
    kind's small f32 config on the card and on the CPU, TF32 off, the same
    injected draws, rendered speech as the target, each step from the same
    initial weights (the mel-VAE's target is silence), and the same steps in
    float64 on the CPU: losses within 1e-4 relative; each network's update
    held by `_adam_first_step`."""
    from kalle_tpu_torch.bridge import tree_leaves, tree_map
    from kalle_tpu_torch.models.codecs import discriminators as disc
    from kalle_tpu_torch.models.codecs import melvae, oobleck, sigmavae
    from kalle_tpu_torch.train import codec_trainer as ct

    lr, wd, failed = 1e-3, 1e-4, []  # wd: make_codec_optimizer's AdamW decay
    for kind in P9_KINDS:
        g = torch.Generator().manual_seed(91)
        cfg, gen, dcfg, weights, adv = p9_codec(kind, "small", g, "cpu")
        dp = disc.init_params(dcfg, g, "cpu")
        hop = getattr(cfg, "hop", None) or cfg.downsampling_ratio
        wav = torch.from_numpy(p9_clips(kind, cfg, 2, 64 * hop, 94))
        if kind == "melvae":
            # silence, as tests/test_torch_codec_train.py trains this kind, and a
            # louder last conv (at its N(0, 0.01) init the decoder is near-silent):
            # against speech the card's f32 gradient was 2.4 times its bound from
            # the float64 one (PERF.md §6, PR 14)
            wav = torch.zeros_like(wav)
            gen["decoder"]["conv_post"]["w"] *= 30.0
        with torch.no_grad():
            x = wav.transpose(1, 2)
            if kind == "melvae":
                t = melvae.forward(gen, cfg, wav, g)[1][1].shape[-1]
                shape = (2, t, cfg.latent_dim)
            elif kind == "sigma":
                shape = tuple(sigmavae.encode_nwc(gen, cfg, x).shape)
            else:
                b, t, c = oobleck.encode_nwc(gen, cfg, x).shape
                shape = (b, t, c // 2)
        noise, u, noise_d = (torch.randn(shape, generator=g), torch.rand(shape, generator=g),
                             torch.randn(shape, generator=g))
        kw = dict(resolutions=((256, 64, 256), (512, 128, 512)), adv_type=adv,
                  latent_mask_ratio=0.1)
        out = {}
        for run, dev, dt in (("cpu", "cpu", torch.float32), ("card", "cuda", torch.float32),
                             ("f64", "cpu", torch.float64)):
            def state():
                mv = lambda tree: tree_map(lambda t: t.detach().clone().to(dev, dt), tree)
                return ct.make_state(mv(gen), mv(dp), ct.make_codec_optimizer(lr),
                                     ct.make_codec_optimizer(lr))

            def used(opt, leaves):  # the step's gradient: a first moment is (1 - b1)·g
                b1 = opt.param_groups[0]["betas"][0]
                return [(opt.state[p]["exp_avg"] / (1 - b1)).cpu() for p in leaves]

            w, n, m, nd = (t.to(dev, dt) for t in (wav, noise, u, noise_d))
            sg, sd = state(), state()
            _, mg = ct.generator_step(sg, kind, cfg, dcfg, weights, w, noise=n,
                                      mask_uniform=m, **kw)
            _, md = ct.discriminator_step(sd, kind, cfg, dcfg, w, adv_type=adv, noise=nd)
            lg, ld = tree_leaves(sg.gen_params), tree_leaves(sd.disc_params)
            out[run] = {"metrics": {k: float(v) for k, v in {**mg, **md}.items()},
                        "gen": (used(sg.gen_opt, lg), lg), "disc": (used(sd.disc_opt, ld), ld)}
        cpu, card, f64 = out["cpu"], out["card"], out["f64"]
        loss_err = max(abs(card["metrics"][k] - v) / max(1.0, abs(v))
                       for k, v in cpu["metrics"].items())
        res = {net: _adam_first_step(card[net][1], cpu[net][1], tree_leaves(p0), card[net][0],
                                     cpu[net][0], f64[net][0], lr, wd)
               for net, p0 in (("gen", gen), ("disc", dp))}
        log(f"  (b) {kind} card vs CPU: loss {loss_err:.3g}; " + "; ".join(
            f"{net}: grad {r['grad']:.3g} of its bound, AdamW rule {r['rule']:.3g}·lr, "
            f"param {r['param']:.3g}·lr, below the gate {r['below']:.4f} of {r['n']}"
            for net, r in res.items()))
        if not (loss_err <= 1e-4 and all(
                r["grad"] <= 1 and r["rule"] <= 1e-2 and r["param"] <= 1e-2
                and r["below"] <= P9_BELOW_MAX for r in res.values())):
            failed.append(kind)
    if failed:
        raise AssertionError(f"(b) card vs CPU step disagrees: {failed}")
    log("  (b) small f32 codec steps (sigma and oobleck against speech), card vs CPU (TF32 "
        "off): within the limits (loss 1e-4; grad 1 of its bound; rule 1e-2; param 1e-2; "
        f"below the gate {P9_BELOW_MAX})")


def p9_flow_kl(card: str) -> None:
    """(c) flow_space_kl through a latent-1024 mel-VAE flow (the
    melvae_dim2048_tts_sft shape) at batch 8 x 128 frames."""
    from kalle_tpu_torch.bridge import tree_leaves
    from kalle_tpu_torch.models.codecs import melvae
    from kalle_tpu_torch.train.flow_kl import flow_space_kl

    g = torch.Generator(device="cuda").manual_seed(92)
    cfg = dataclasses.replace(melvae.MelVAEConfig(), latent_dim=1024)
    params = melvae.init_params(cfg, g, "cuda")
    for f in params["flows"]:  # a fresh flow is the identity
        f["post"]["w"] = 0.02 * torch.randn(f["post"]["w"].shape, generator=g, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    b, t, d = 8, 128, cfg.latent_dim
    mean = torch.randn(b, t, d, generator=g, device="cuda").requires_grad_(True)
    logs = (0.1 * torch.randn(b, t, d, generator=g, device="cuda")).requires_grad_(True)
    labels = torch.cat([torch.randn(b, t, d, generator=g, device="cuda"),
                        0.1 * torch.randn(b, t, d, generator=g, device="cuda")], -1)
    tm = (torch.rand(b, t, generator=g, device="cuda") > 0.1).float()

    def run():
        loss = flow_space_kl(params, cfg, {"pre_mean": mean, "pre_log_scale": logs}, labels,
                             tm, g)
        return loss, torch.autograd.grad(loss, (mean, logs), materialize_grads=True)

    run()
    (loss, (g_mean, g_logs)), ms = _timed(run)
    if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(g_logs).all())
            and float(g_logs.abs().max()) > 0 and float(g_mean.abs().max()) == 0.0
            and all(p.grad is None for p in tree_leaves(params))):
        raise AssertionError("flow_space_kl: loss or gradients wrong")
    log(f"flow_space_kl batch {b} frames {t} latent {d} ms {ms:.2f} (forward and gradient, "
        f"host clock) loss {float(loss.detach()):.4f}: finite; pre_log_scale has a gradient, "
        f"pre_mean's is 0 as in JAX (the flow output is a constant), the flow's params none "
        f"card {card}")
    for p in tree_leaves(params):
        p.requires_grad_(False)


def p9_eval(card: str, root: str) -> dict:
    """(d) train the CTC ASR and the speaker embedder, then score a fresh
    infer_jsonl's wavs: wer_pipeline on the gen and copysyn arms, speaker
    similarity with the trained ECAPA and the spectral embedder, margin.
    Returns the scoring run's launches."""
    from kalle_tpu_torch.data import synth_speech as sl
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.eval import ctc_asr, harness, speaker_embedder as se
    from kalle_tpu_torch.infer.pipeline import Codec, InferTools

    rng = np.random.default_rng(93)
    cfg = ctc_asr.CTCConfig()
    texts = [sl.random_sentence(rng) for _ in range(32)]
    # render alone, then train_ctc as a whole (it renders the same bank again);
    # the difference is the training
    bank, render_ms = _timed(lambda: ctc_asr.make_training_bank(cfg, texts, 4, 2, seed=93,
                                                                device="cuda"))
    (params, curve), ms = _timed(lambda: ctc_asr.train_ctc(
        cfg, texts, n_speakers=4, n_render=2, steps=P9_ASR_STEPS, batch=16, lr=2e-3,
        seed=93, log_every=10, device="cuda"))
    log(f"ctc_asr CTCConfig() clips {len(bank[4])} render_s {render_ms / 1e3:.2f} train_ctc_s "
        f"{ms / 1e3:.2f} steps {P9_ASR_STEPS} ms_per_step {(ms - render_ms) / P9_ASR_STEPS:.2f} "
        f"(train_ctc less the render) loss first {curve[0]:.3f} last {curve[-1]:.3f} "
        f"card {card}")
    if not (np.isfinite(curve).all() and curve[-1] < curve[0]):
        raise AssertionError(f"the CTC loss did not fall: {curve}")
    scfg = dataclasses.replace(se.SpeakerTrainConfig(), steps=P9_SPK_STEPS)
    sbank, render_ms = _timed(lambda: se._render_bank(scfg, device="cuda"))
    (sparams, ecfg, scurve), ms = _timed(lambda: se.train_speaker_embedder(scfg,
                                                                          device="cuda"))
    log(f"speaker_embedder SpeakerTrainConfig() clips {len(sbank[1])} render_s "
        f"{render_ms / 1e3:.2f} train_s {ms / 1e3:.2f} steps {P9_SPK_STEPS} ms_per_step "
        f"{(ms - render_ms) / P9_SPK_STEPS:.2f} (train_speaker_embedder less the render) loss "
        f"first {scurve[0]:.3f} last {scurve[-1]:.3f} card {card}")
    if not (np.isfinite(scurve).all() and scurve[-1] < scurve[0]):
        raise AssertionError(f"the speaker loss did not fall: {scurve}")
    pos, neg = se.margin(sparams, ecfg, scfg)
    log(f"  speaker margin (held-out renders): same-speaker {pos:.4f} cross-speaker {neg:.4f}")

    # a fresh infer_jsonl at phase 6's shape (phase 6's directory is gone)
    lm = flagship_cfg()
    L = lm.llama.num_layers
    lm_params = flagship_int8(torch.Generator(device="cuda").manual_seed(0))
    codec = Codec.random_init("sigma", torch.Generator(device="cuda").manual_seed(6),
                              "cuda").astype(torch.bfloat16)
    blocks = len(codec.cfg.strides) * codec.cfg.blocks_per_stage
    rows = []
    for i, text in enumerate(serve_texts(P9_SCORE_ROWS, rng)):
        path = os.path.join(root, f"lat{i}.npy")
        np.save(path, rng.normal(size=(1, int(rng.integers(40, 121)), 64)).astype(np.float32))
        rows.append({"id": f"u{i}", "caption": text, "vae": path})
    it = InferTools(lm, lm_params, ByteTokenizer(), codec, output_root=root, version="phase9",
                    ckpt_name="random", timestamp=False)
    out = it.output_dir
    transcribe = ctc_asr.make_ctc_transcriber(params, cfg)
    trained = se.make_trained_embedder(sparams, ecfg, scfg)
    spectral = harness.make_spectral_embedder(16000, "cuda")

    def score():
        it.infer_jsonl(rows, max_frames=INFER_FRAMES, batch_size=P9_SCORE_ROWS)
        with open(os.path.join(out, "meta.lst"), "w") as f:
            for r in rows:  # the copysyn wav stands as the voice prompt
                f.write(f"{r['id']}|prompt|{os.path.join(out, r['id'] + '---copysyn.wav')}|"
                        f"{r['caption']}\n")
        meta = os.path.join(out, "meta.lst")
        res = {"wer_gen": harness.wer_pipeline("en", out, meta, transcribe),
               "wer_copysyn": harness.wer_pipeline("en", out, meta, transcribe,
                                                   gen_suffix="---copysyn.wav")}
        items = harness.read_meta_lst(meta)
        for name, fn in (("sim_ecapa", trained), ("sim_spectral", spectral)):
            res[name] = harness.speaker_similarity(out, items, fn)
            with open(os.path.join(out, "0000000_sim,json")) as f:
                res[name + "_n"] = len(json.load(f))
        return res

    (res, counts), ms = _timed(lambda: _counted(score))
    expect = {"decode_attention": L * INFER_FRAMES, "qmm": 4 * L * INFER_FRAMES,
              "fused_mlp": L * INFER_FRAMES, "convnext_block": blocks * (P9_SCORE_ROWS + 1)}
    check_launches("scoring run (infer_jsonl, ASR, speaker similarity)", counts, expect)
    files = ["aaa_gt.txt", "aaa_asr.txt", "000000000_wer.txt", "000000000_wer_copysyn.txt",
             "0000000_sim,json", "0000000_sim.txt", "meta.lst"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    vals = [res[k] for k in ("wer_gen", "wer_copysyn", "sim_ecapa", "sim_spectral")]
    if missing or not np.isfinite(vals).all() or res["sim_ecapa_n"] != P9_SCORE_ROWS \
            or res["sim_spectral_n"] != P9_SCORE_ROWS:
        raise AssertionError(f"scoring: missing {missing}, values {res}")
    log(f"score rows {P9_SCORE_ROWS} wall_s {ms / 1e3:.3f} (infer_jsonl + ASR + 2 similarity "
        f"passes) wer_gen {res['wer_gen']:.2f} wer_copysyn {res['wer_copysyn']:.2f} sim_ecapa "
        f"{res['sim_ecapa']:.4f} sim_spectral {res['sim_spectral']:.4f} (random weights: no "
        f"quality bar) card {card}")
    del lm_params
    torch.cuda.empty_cache()
    return counts


def p9_demo() -> None:
    """(e) the codec demo entry point in process on the card."""
    import contextlib
    import io

    from kalle_tpu_torch.train import codec_demo

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, ms = _timed(lambda: codec_demo.main(["--size", "small", "--steps", "4", "--gan"]))
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = ["snr_db", "mrstft", "holdout_snr_db", "holdout_mrstft", "steps", "size", "gan",
            "kind", "warmup_steps", "clips", "holdout_clips", "wall_s"]
    if list(last) != keys or not np.isfinite([last[k] for k in keys[:4]]).all():
        raise AssertionError(f"codec_demo printed {last}")
    log(f"  (e) python -m kalle_tpu_torch.train.codec_demo --size small --steps 4 --gan: "
        f"{json.dumps(last)} ({ms / 1e3:.1f} s in process)")


def phase_codec_training(card: str) -> dict:
    """Phase 9: the codec trainer at each codec's default config, small
    steps card vs CPU, flow_space_kl, the eval models and the scoring of
    generated wavs, the codec demo. Returns the scoring run's launches."""
    log("# phase 9: codec training (sigma, melvae, oobleck), flow-space KL, CTC ASR, "
        "speaker embedder, WER and speaker similarity")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        for kind in P9_KINDS:
            p9_trainer(card, kind, root)
        p9_small_reference()
        p9_flow_kl(card)
        counts = p9_eval(card, root)
    p9_demo()
    log(f"phase 9 s {time.perf_counter() - t0:.1f}")
    return counts


# --------------------------------------------------------------- phase 10 ---
# (a): the trainer's depth (full width, depth cut) and steps; the batcher's
# requests, batch and frames
P10_LAYERS, P10_STEPS, P10_REQS, P10_B, P10_FRAMES = 4, 8, 16, 8, 64
P10_TP = (2, 4, 8)


def p10_fit(root: str, tag: str, fsdp: bool = False):
    """Trainer.fit of phase 4's model at depth P10_LAYERS for P10_STEPS steps
    (a process group or none, as the caller set it up). -> (losses,
    params after, ms a step of the steps after the first, launches)."""
    import shutil

    from kalle_tpu_torch.bridge import tree_leaves
    from kalle_tpu_torch.core.config import (DataConfig, ExperimentConfig, LlamaConfig,
                                             LlasaConfig, TrainConfig)
    from kalle_tpu_torch.data.tokens import build_tokenizer
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.train.trainer import Trainer

    model = LlasaConfig(llama=LlamaConfig(num_layers=P10_LAYERS, use_flash_attention=True),
                        latent_dim=64, audio_proj_dim=2048, head_variant="sigma")
    exp_dir = os.path.join(root, f"p10_{tag}")
    exp = ExperimentConfig(
        project_name="p10", exp_dir=exp_dir, model=model,
        train=TrainConfig(lr=5e-5, warmup_steps=2, total_steps=1000,
                          gradient_accumulation_steps=TRAIN_A, log_interval=1,
                          save_interval=10 ** 9, seed=0, fsdp=fsdp),
        data=DataConfig(meta_path=os.path.join(root, "meta.jsonl"), batch_size=TRAIN_B,
                        use_dynamic=False, num_workers=1, prefetch_size=4,
                        length_buckets=(TRAIN_T,), max_length=TRAIN_T))
    trainer = Trainer(exp, build_tokenizer(), device="cuda")
    _build.reset_launches()
    trainer.fit(max_steps=P10_STEPS)
    launches = {k: v for k, v in _build.launches().items() if v}
    expect = P10_LAYERS * TRAIN_A * P10_STEPS
    if launches != {"flash_fwd": expect, "flash_bwd_dq": expect, "flash_bwd_dkv": expect}:
        raise AssertionError(f"train {tag}: launches {launches}, the path implies {expect} "
                             "of each of K5-K7")
    losses = [h["total_loss"] for h in trainer.history]
    params = [p.detach().clone() for p in tree_leaves(trainer.state.params)]
    ms = sorted(1e3 / h["steps_per_s"] for h in trainer.history[1:])
    mesh = None if trainer.mesh is None else trainer.mesh.shape
    del trainer
    shutil.rmtree(exp_dir)
    torch.cuda.empty_cache()
    return losses, params, ms[len(ms) // 2], launches, mesh


def p10_serve(params: dict, prompts: list, mesh=None):
    """Greedy ContinuousBatcher.run of the prompts at batch P10_B, P10_FRAMES
    frames. -> (completions by index, ms a decode step, launches)."""
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
    from kalle_tpu_torch.ops.kernels import _build

    cfg = flagship_cfg()
    cb = ContinuousBatcher(params, cfg, batch_size=P10_B, max_frames=P10_FRAMES,
                           prompt_buckets=SERVE_BUCKETS, greedy=True, mesh=mesh)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    comps = {c.index: c for c in cb.run(prompts)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches().items() if v}
    L, steps = cfg.llama.num_layers, cb.step_count
    expect = {"decode_attention_sideband": L * steps, "qmm": 4 * L * steps,
              "fused_mlp": L * steps}
    if launches != expect or sorted(comps) != list(range(len(prompts))):
        raise AssertionError(f"serve (mesh {mesh is not None}): launches {launches}, the "
                             f"path implies {expect}; completions {sorted(comps)}")
    return comps, wall / steps * 1e3, launches


def p10_world1(card: str, root: str) -> dict:
    """(a) The mesh paths at world size 1 over NCCL against the same runs
    without a process group: bit-identical. Returns the mesh runs' launches."""
    import torch.distributed as dist

    from kalle_tpu_torch.data.tokens import build_prompt_ids, build_tokenizer
    from kalle_tpu_torch.parallel import multihost
    from kalle_tpu_torch.parallel.mesh import make_mesh, shard_params

    log(f"# phase 10(a): the mesh paths at world size 1 over NCCL: Trainer.fit at full "
        f"width, depth {P10_LAYERS}, batch {TRAIN_B} x {TRAIN_T}, {TRAIN_A} microbatches, "
        f"{P10_STEPS} steps (dp=-1 tp=1 pp=1, then fsdp); ContinuousBatcher of "
        f"{P10_REQS} greedy requests at batch {P10_B}, {P10_FRAMES} frames")
    write_latents(root, TRAIN_B * TRAIN_A * P10_STEPS)
    alone = p10_fit(root, "alone")
    tok = build_tokenizer()
    prompts = [np.asarray(build_prompt_ids(tok, t))
               for t in serve_texts(P10_REQS, np.random.default_rng(10))]
    params = flagship_int8(torch.Generator(device="cuda").manual_seed(0))  # phase 3's weights
    serve_alone = p10_serve(params, prompts)
    counts: dict = {}
    multihost.initialize(init_method="file://" + os.path.join(root, "store"), world_size=1,
                         rank=0, device="cuda")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected one NCCL rank, got {dist.get_backend()} x "
                                 f"{dist.get_world_size()}")
        ms = {"alone": alone[2]}
        for fsdp in (False, True):
            tag = "fsdp" if fsdp else "mesh"
            losses, got, ms[tag], launches, shape = p10_fit(root, tag, fsdp)
            same = losses == alone[0] and all(torch.equal(a, b) for a, b in zip(got, alone[1]))
            log(f"  Trainer.fit on mesh {shape}{' fsdp' if fsdp else ''}: losses {losses} "
                f"bit-identical to the run without a process group: {same}")
            if not same:
                raise AssertionError(f"{tag}: the world-1 mesh run differs from the run "
                                     f"without a process group ({alone[0]})")
            for k, v in launches.items():
                counts[k] = counts.get(k, 0) + v
            del got
        log(f"train world1 ms_per_step no_group {ms['alone']:.2f} mesh {ms['mesh']:.2f} "
            f"fsdp {ms['fsdp']:.2f} (median of steps 2..{P10_STEPS}) card {card}")
        mesh = make_mesh(dp=1, tp=1, device_type="cuda")
        comps, serve_ms, launches = p10_serve(shard_params(params, mesh), prompts, mesh)
        for i, c in serve_alone[0].items():
            d = comps[i]
            if not (c.n_frames == d.n_frames and np.array_equal(c.means, d.means)
                    and np.array_equal(c.samples, d.samples)
                    and np.array_equal(c.log_scales, d.log_scales)):
                raise AssertionError(f"request {i}: the mesh batcher's completion differs")
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        log(f"  ContinuousBatcher(mesh=make_mesh(dp=1, tp=1)): {len(comps)} completions "
            "bit-identical to mesh=None")
        log(f"serve world1 ms_per_step no_group {serve_alone[1]:.4f} mesh {serve_ms:.4f} "
            f"(batch {P10_B}, admission and prefill included) card {card}")
    finally:
        dist.destroy_process_group()
    return counts


def phase_parallel(card: str) -> dict:
    """Phase 10: (a) the world-1 mesh paths, (b) the tp shard shapes
    (parallel/tp_probe.py) at tp 2, 4 and 8. Returns (a)'s launches."""
    from kalle_tpu_torch.parallel import tp_probe

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        counts = p10_world1(card, root)
    log(f"# phase 10(b): tp shard shapes at full width, bf16, int8 layer weights, batch "
        f"{BATCH}, cache {SERVE_CACHE}; training attention at batch {TRAIN_B} x {TRAIN_T}")
    g = torch.Generator(device="cuda").manual_seed(10)
    for tp in P10_TP:
        tp_probe.check(flagship_cfg().llama, tp, batch=BATCH, cache_len=SERVE_CACHE,
                       train_batch=TRAIN_B, train_t=TRAIN_T, g=g, log=log)
    log(f"phase 10 s {time.perf_counter() - t0:.1f}")
    return counts


# -------------------------------------------------------------- phase 11 ----

# (a) TTFA (batch, timed chunk calls), open-loop rates and requests; (b) the
# HTTP bench; (c) the JAX tiny WER run's arguments (experiments/
# experiment_tiny_wer.json); (e) the microbenches; (f) the native library
P11_TTFA = ((1, 10), (8, 6))
P11_RATES, P11_POISSON_REQS, P11_CHUNK = "2,4", 32, 8
P11_HTTP_REQS, P11_HTTP_RATE, P11_HTTP_FRAMES = 16, 2, 64
P11_CHAIN = ["--tiny", "--steps", "1500", "--rows", "6", "--seconds", "0.5"]
P11_CHAIN_MAX_FRAMES = 208  # the tool's default: 0.5 s at 8 kHz, hop 20, + 8
JAX_TINY_RUN = {"loss_drop": 0.005980953154769981, "latent_gate": 0.010318594639973581,
                "prompt_clone": (0.3116759428133567, -0.06077609562780708),
                "end_detection": 0.8333333333333334, "wer_copysyn": 4.545454545454546,
                "wer_gen": 27.272727272727273, "speaker_margin": (0.8021905422210693,
                                                                  0.24299830198287964)}
P11_TRAIN = ("b8,t512,flash", "b8,t512,flash,remat", "b8,t512,flash,dots")
P11_NATIVE_PAIRS, P11_NATIVE_FILES = 200, 64
SIDEBAND = "decode_attention_sideband"
K_ALL = K1_K4 + (SIDEBAND, "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def p11_check(what: str, got: dict, expect: dict) -> None:
    """Every kernel's count of one run against what the path implies, exactly
    (a kernel `expect` leaves out: 0)."""
    for name in K_ALL:
        if got.get(name, 0) != expect.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {got.get(name, 0)} times, the path "
                                 f"implies {expect.get(name, 0)}")
    log(f"  {what}: launches " + json.dumps({k: got[k] for k in K_ALL if got.get(k)})
        + " (as the path implies)")


def p11_counted(what: str, fn, expect_fn):
    """Run fn() with the counts set to 0 just before, check them against
    expect_fn(fn's result) just after; -> (result, counts)."""
    from kalle_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = _build.launches()
    p11_check(what, got, expect_fn(out))
    return out, got


def p11_latency(card: str, counts: dict) -> None:
    """(a) latency_bench at full width: TTFA at batch 1 and 8, the open-loop
    rates, the interleave mode at batch 1."""
    from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig
    from kalle_tpu_torch.tools import latency_bench

    L = flagship_cfg().llama.num_layers
    c = SigmaVAEConfig()
    blocks = len(c.strides) * c.blocks_per_stage  # each of encoder and decoder
    for B, iters in P11_TTFA:
        n_full = max(iters // 2, 1)
        frames = P11_CHUNK + MAX_FRAMES + iters * P11_CHUNK + n_full * MAX_FRAMES
        decodes = 2 + iters + n_full
        lines, got = p11_counted(
            f"latency_bench batch {B}",
            lambda: latency_bench.main(["--batch", str(B), "--iters", str(iters),
                                        "--chunk-frames", str(P11_CHUNK),
                                        "--max-frames", str(MAX_FRAMES)]),
            lambda _: {"decode_attention": L * frames, "convnext_block": blocks * decodes})
        ttfa, rtf = lines
        log(f"ttfa batch {B} p50_s {ttfa['value']} p95_s {ttfa['p95']} ({iters} calls of "
            f"{P11_CHUNK} frames + codec) rtf_incl_codec {rtf['value']} ({MAX_FRAMES} frames, "
            f"{n_full} calls) card {card}")
        _add(counts, got)
    lines, got = p11_counted(
        "latency_bench --poisson",
        lambda: latency_bench.main(["--poisson", P11_RATES, "--continuous",
                                    str(P11_POISSON_REQS), "--serve-batch", "8",
                                    "--chunk-frames", str(P11_CHUNK),
                                    "--max-frames", str(MAX_FRAMES)]),
        lambda out: {SIDEBAND: L * sum(x["decode_steps"] for x in out)})
    for x in lines:
        if x["p50_ttfa_s"] is None or x["requests"] != P11_POISSON_REQS:
            raise AssertionError(f"open loop: {x}")
        log(f"open_loop rate {x['rate_req_s']} req_s batch 8 requests {x['requests']} "
            f"ttfa_p50_s {x['p50_ttfa_s']} ttfa_p95_s {x['p95_ttfa_s']} e2e_p50_s "
            f"{x['p50_e2e_s']} e2e_p95_s {x['p95_e2e_s']} wall_s {x['wall_s']} card {card}")
    _add(counts, got)
    iters = 6
    n_full = iters // 2
    frames = P11_CHUNK + MAX_FRAMES + iters * P11_CHUNK + n_full * MAX_FRAMES
    lines, got = p11_counted(
        "latency_bench --interleave",
        lambda: latency_bench.main(["--interleave", "--batch", "1", "--iters", str(iters),
                                    "--chunk-frames", str(P11_CHUNK),
                                    "--max-frames", str(MAX_FRAMES)]),
        # the delay warm-up's encode, then one decode a call
        lambda _: {"decode_attention": L * frames,
                   "convnext_block": blocks * (1 + 2 + iters + n_full)})
    log(f"interleave batch 1 ttfa_p50_s {lines[0]['value']} p95_s {lines[0]['p95']} "
        f"rtf_incl_codec {lines[1]['value']} card {card}")
    _add(counts, got)


def p11_http(card: str, counts: dict) -> None:
    """(b) http_bench at full width: every client's body whole, no error."""
    from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig
    from kalle_tpu_torch.tools import http_bench

    L = flagship_cfg().llama.num_layers
    c = SigmaVAEConfig()
    (line,), got = p11_counted(
        "http_bench",
        lambda: http_bench.main(["--rates", str(P11_HTTP_RATE), "--requests",
                                 str(P11_HTTP_REQS), "--max-frames", str(P11_HTTP_FRAMES),
                                 "--chunk-frames", str(P11_CHUNK), "--serve-batch", "8"]),
        lambda out: {SIDEBAND: L * out[0]["decode_steps"],
                     "convnext_block": len(c.strides) * c.blocks_per_stage * out[0]["chunks"]})
    want = 44 + (P11_HTTP_FRAMES - 1) * c.hop * 2
    sizes = [None if b is None else len(b) for b in line["bodies"]]
    if line["errors"] or sizes != [want] * P11_HTTP_REQS:
        raise AssertionError(f"http_bench: {line['errors']} errors, body bytes {sizes}, "
                             f"each should be {want}")
    log(f"http_open_loop rate {line['rate_req_s']} req_s requests {line['requests']} errors 0 "
        f"ttfa_p50_s {line['p50_ttfa_s']} ttfa_p95_s {line['p95_ttfa_s']} e2e_p50_s "
        f"{line['p50_e2e_s']} e2e_p95_s {line['p95_e2e_s']} (every body {want} bytes) "
        f"card {card}")
    _add(counts, got)


def p11_subprocess(what: str, cmd: list, timeout: int) -> list:
    """cmd in a process of its own from the checkout's root; -> its stdout lines."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    log(f"  {what}: wall_s {time.perf_counter() - t0:.1f} (process start included)")
    return proc.stdout.splitlines()


# the chain's gates that hold its machinery: training, the checkpoint, the
# writes, the codec channel's transcription and the trained embedder; the
# other three grade what the tiny LM learned from one draw of the frozen
# codec and its data, and pass or fail with that draw on the card and on
# the CPU alike (PERF.md §6: 1 in 4 draws passes all nine at these
# arguments on either), so they are printed, and the witness holds the
# card's arithmetic to the CPU's on the chain's own LM
P11_MECHANICAL = ("loss_drop", "latent_gate", "checkpoint_roundtrip", "all_wavs_written",
                  "wer_copysyn", "speaker_margin")
P11_LEARNED = ("prompt_clone", "end_detection", "wer_gen")
P11_WITNESS_FRAMES, P11_WITNESS_HELD, P11_WITNESS_END_STEPS = 32, 8, 150


def p11_chain_witness(root: str, cfg_path: str, steps: int, max_frames: int) -> dict:
    """The card against the CPU on the chain's own trained LM and rows,
    which tells a fault of the card's path from the chain's random draws
    (the card's generators draw other numbers than the CPU's): (a) the
    restored LM's loss and gradients on the first two rows at the
    trainer's bucket, one fixed noise draw, K5-K7 on the card; (b)
    P11_WITNESS_FRAMES greedy frames of every row, K1 on the card, the
    first P11_WITNESS_HELD held; (c) the
    end-detection arm's LM from one CPU-drawn init, trained on the card
    (K5-K7) and on the CPU, its final loss and its stop frames; (d) the
    latent gate of the card-trained LM decoded on the CPU. (a)-(c) must
    agree within their limits. -> the numbers."""
    from kalle_tpu_torch.bridge import tree_leaves, tree_map
    from kalle_tpu_torch.core.checkpoint import CheckpointManager
    from kalle_tpu_torch.core.config import (LlamaConfig, LlasaConfig, TrainConfig,
                                             load_experiment_config)
    from kalle_tpu_torch.data.collate import Item, collate
    from kalle_tpu_torch.data.tokens import build_prompt_ids, build_tokenizer
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.kernels import _build
    from kalle_tpu_torch.tools import run_experiment as rx
    from kalle_tpu_torch.train.step import loss_fn, make_train_state, train_step
    from kalle_tpu_torch.train.trainer import device_batch

    exp, _ = rx.tiny_experiment(load_experiment_config(cfg_path), steps)
    exp = dataclasses.replace(exp, exp_dir=root)
    cfg, L = exp.model, exp.model.llama.num_layers
    with open(os.path.join(root, exp.project_name, "data", "meta.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    tok = build_tokenizer(exp.tokenizer_path or None)
    template = make_train_state(llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                exp.train)
    restored, _ = CheckpointManager(os.path.join(exp.output_dir, "torch")).restore(template)
    params = {"cuda": tree_map(lambda t: t.detach().cuda(), restored.params),
              "cpu": tree_map(lambda t: t.detach().cpu(), restored.params)}
    lats = [rx._gt_latents(r).astype(np.float32) for r in rows]
    ids = [np.asarray(build_prompt_ids(tok, r["caption"]), np.int32) for r in rows]
    res: dict = {}

    def rel(a, b):
        return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)

    # (a) loss and gradients
    nb = collate([Item(input_ids=i, audio_latents=x, audio_distribution=x.copy())
                  for i, x in zip(ids[:2], lats[:2])], pad_token_id=tok.pad_token_id,
                 buckets=exp.data.length_buckets)
    noise = np.random.default_rng(0).standard_normal(nb["audio_latents"].shape
                                                    ).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.clone().requires_grad_(True), params[dev])
        k5 = _build.launches().get("flash_fwd", 0)
        total, m = loss_fn(p, cfg, exp.train, device_batch(nb, dev),
                           latent_noise=torch.from_numpy(noise).to(dev))
        total.backward()
        got[dev] = (float(m["audio_loss"].detach()), [t.grad.cpu() for t in tree_leaves(p)],
                    _build.launches().get("flash_fwd", 0) - k5)
    res["loss"] = (got["cuda"][0], got["cpu"][0])
    res["grad_rel"] = max(rel(a, b) for a, b in zip(got["cuda"][1], got["cpu"][1]))
    log(f"  witness (a): loss card {res['loss'][0]:.7g} CPU {res['loss'][1]:.7g}, worst "
        f"gradient {res['grad_rel']:.3g} of its largest entry")
    if got["cuda"][2] != L or abs(res["loss"][0] - res["loss"][1]) > 1e-5 * res["loss"][1] \
            or not res["grad_rel"] <= 1e-4:
        raise AssertionError(f"the chain's LM, card (K5 {got['cuda'][2]}) vs CPU: loss "
                             f"{res['loss']}, worst gradient {res['grad_rel']:.3g} of its "
                             "largest entry (limits 1e-5, 1e-4)")

    # (b) greedy frames: each frame feeds the next, so rounding grows with
    # the frames; the first P11_WITNESS_HELD are held to 1e-4
    diff = torch.zeros(P11_WITNESS_FRAMES)
    for i in ids:
        means = []
        for dev in ("cuda", "cpu"):
            t = torch.from_numpy(i[None].astype(np.int64)).to(dev)
            means.append(generate(params[dev], cfg, t, torch.ones_like(t, dtype=torch.int32),
                                  max_frames=P11_WITNESS_FRAMES, end_kl_threshold=-1.0,
                                  greedy=True).means.cpu())
        diff = torch.maximum(diff, (means[0] - means[1]).abs().amax((0, 2)))
    res["frames_max_abs"] = (float(diff[:P11_WITNESS_HELD].max()), float(diff.max()))
    log(f"  witness (b): greedy frames, card vs CPU within {res['frames_max_abs'][0]:.3g} over "
        f"the first {P11_WITNESS_HELD}, {res['frames_max_abs'][1]:.3g} over "
        f"{P11_WITNESS_FRAMES}")
    if not res["frames_max_abs"][0] <= 1e-4:
        raise AssertionError(f"the chain's LM, {P11_WITNESS_HELD} greedy frames: card vs CPU "
                             f"differ by {res['frames_max_abs'][0]:.3g} (limit 1e-4)")

    # (c) the end-detection arm from one init
    ecfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=cfg.latent_dim,
                       audio_proj_dim=64, head_variant="stableaudio")
    etcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=P11_WITNESS_END_STEPS,
                        end_loss_weight=1.0)
    sub = [x[::max(len(x) // 200, 1)] for x in lats]
    enb = collate([Item(input_ids=i, audio_latents=x,
                        audio_distribution=np.concatenate([x, 0.5 * np.ones_like(x)], -1))
                   for i, x in zip(ids, sub)], pad_token_id=tok.pad_token_id,
                  buckets=exp.data.length_buckets)
    init = llasa.init_params(ecfg, torch.Generator().manual_seed(0), "cpu")
    end = {}
    for dev in ("cuda", "cpu"):
        state = make_train_state(tree_map(lambda t: t.clone().to(dev), init), etcfg)
        batch = device_batch(enb, dev)
        for _ in range(P11_WITNESS_END_STEPS):
            m = train_step(state, ecfg, etcfg, batch, seed=1)
        frames = []
        for i, x in zip(ids, sub):
            t = torch.from_numpy(i[None].astype(np.int64)).to(dev)
            r = generate(state.params, ecfg, t, torch.ones_like(t, dtype=torch.int32),
                         torch.Generator(device=dev).manual_seed(21),
                         max_frames=len(x) + 8, greedy=True)
            frames.append(max(int(r.n_frames[0]) - 1, 0))
        end[dev] = (float(m["total_loss"]), frames)
    res["end_loss"] = (end["cuda"][0], end["cpu"][0])
    res["end_frames"] = (end["cuda"][1], end["cpu"][1])
    res["end_rows"] = [len(x) for x in sub]
    log(f"  witness (c): the end arm from one init, {P11_WITNESS_END_STEPS} steps: loss card "
        f"{res['end_loss'][0]:.7g} CPU {res['end_loss'][1]:.7g}, stop frames "
        f"{res['end_frames'][0]} / {res['end_frames'][1]} of {res['end_rows']}")
    if abs(res["end_loss"][0] - res["end_loss"][1]) > 1e-3 * res["end_loss"][1]:
        raise AssertionError(f"the end arm from one init, card vs CPU: final loss "
                             f"{res['end_loss']} (limit 1e-3 relative)")

    # (d) the card-trained LM's latent gate, decoded on the CPU
    res["latent_gate_cpu_decode"] = rx.latent_gate(params["cpu"], cfg, tok, rows, max_frames)
    return res


def p11_chain(card: str, counts: dict) -> None:
    """(c) the experiment chain on the card in its own process, the WER arm
    on, at the JAX tiny WER run's arguments: its nine gates beside that
    run's values (the six mechanical ones must pass), every launch count
    against the steps the chain reports, and the witness of the card
    against the CPU on the chain's own LM."""
    from kalle_tpu_torch.core.config import LlamaConfig, load_experiment_config

    with tempfile.TemporaryDirectory() as root:
        cfg = os.path.join(root, "sigma_overfit.yaml")
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "sigma_overfit.yaml")
        with open(src) as f, open(cfg, "w") as g:  # one loader worker: a fixed batch order
            g.write(f.read().replace("num_workers: 2", "num_workers: 1"))
        cmd = [sys.executable, "-m", "kalle_tpu_torch.tools.run_experiment", cfg, *P11_CHAIN,
               "--exp-dir", root]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        path = os.path.join(root, "sigma-overfit-tiny", "experiment.json")
        if proc.returncode not in (0, 1) or not os.path.exists(path):
            raise AssertionError(f"run_experiment exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(path) as f:
            res = json.load(f)
        buckets = load_experiment_config(cfg).data.length_buckets
        t0 = time.perf_counter()
        wit = p11_chain_witness(root, cfg, res["steps"], P11_CHAIN_MAX_FRAMES)
        wit_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    got = json.loads(lines[-1].removeprefix("kernel launches "))
    decode_steps = int(lines[-2].removeprefix("decode steps "))
    q, t = res["quality"], res["train"]
    port = {"loss_drop": t["loss_ratio"], "latent_gate": q["latent_rel_mse"],
            "prompt_clone": (q["prompt_clone_sim"], q["prompt_clone_neg_sim"]),
            "end_detection": (q["end_detection_acc"], q["end_detection_mae_frames"]),
            "wer_copysyn": q["wer_copysyn"], "wer_gen": q["wer_gen"],
            "speaker_margin": (q["speaker_margin_pos"], q["speaker_margin_neg"])}
    gates = res["gates"]
    for gate in P11_MECHANICAL + P11_LEARNED:
        log(f"  gate {gate}: {gates[gate]} port {port.get(gate, '-')} "
            f"jax_tiny_run {JAX_TINY_RUN.get(gate, '-')}")
    log(f"  witness (d): the latent gate of the card-trained LM decoded on the CPU "
        f"{wit['latent_gate_cpu_decode']:.6g} (on the card {q['latent_rel_mse']:.6g}); the "
        f"witness's wall_s {wit_s:.1f}")
    if sorted(gates) != sorted(P11_MECHANICAL + P11_LEARNED) or \
            not all(gates[g] for g in P11_MECHANICAL) or \
            proc.returncode != (0 if all(gates.values()) else 1) or \
            not all(np.isfinite(v) for v in (q["prompt_clone_sim"], q["end_detection_acc"],
                                             q["wer_gen"])):
        raise AssertionError(f"the chain's gates: {gates}, exit {proc.returncode}")
    # the tiny f32 LM (remat off): K1's f32 instance once a layer each step
    # of generate's loop; every bucket a multiple of 128, so K5-K7 once a
    # layer in every training step; no int8 weight, no bf16 codec block
    L = LlamaConfig.tiny().num_layers
    if any(b % 128 for b in buckets):
        raise AssertionError(f"the chain's buckets {buckets}: not every step runs flash")
    steps = res["steps"]
    p11_check("run_experiment", got, {"decode_attention": L * decode_steps,
                                      "flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                                      "flash_bwd_dkv": L * steps})
    learned = sum(gates[g] for g in P11_LEARNED)
    log(f"chain gates {sum(gates.values())}/9 (mechanical 6/6, learned {learned}/3) steps "
        f"{steps} rows {res['rows']} decode steps {decode_steps} wall_s {wall:.1f} (process "
        f"start included) card {card}")
    _add(counts, got)


def p11_serve_batch(card: str, counts: dict) -> None:
    """(d) serve_batch in its own process: a tiny int8 model, 4 rows at batch 2."""
    from kalle_tpu_torch.core.checkpoint import save_params_npz
    from kalle_tpu_torch.core.config import load_experiment_config
    from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params
    from kalle_tpu_torch.utils.audio import read_wav

    with tempfile.TemporaryDirectory() as root:
        yaml = os.path.join(root, "tiny.yaml")
        with open(yaml, "w") as f:
            f.write(TINY_YAML)
        cfg = load_experiment_config(yaml).model
        ckpt = os.path.join(root, "tiny_int8.npz")
        save_params_npz(ckpt, quantize_llama_params(
            llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
        meta = os.path.join(root, "req.jsonl")
        with open(meta, "w") as f:
            f.write("\n".join(json.dumps({"id": f"r{i}", "caption": "tiny row " * (i + 1)})
                              for i in range(4)))
        out = os.path.join(root, "out")
        lines = p11_subprocess("serve_batch (tiny int8, 4 rows, batch 2)", [
            sys.executable, "-m", "kalle_tpu_torch.tools.serve_batch", "-c", yaml, "-p", ckpt,
            "-i", meta, "-o", out, "-m", "8", "--batch", "2"], timeout=600)
        done = [os.path.basename(ln.split("] ", 1)[1].split(" ")[0])
                for ln in lines if ln.startswith("[")]
        mtimes = [os.stat(os.path.join(out, n)).st_mtime_ns for n in done]
        if sorted(done) != sorted(os.listdir(out)) or len(done) != 4 or mtimes != sorted(mtimes):
            raise AssertionError(f"serve_batch: completions {done}, files {os.listdir(out)}, "
                                 f"mtimes in completion order {mtimes}")
        written = done
        hop = SigmaVAEConfig.tiny().hop  # the tool's random codec for a latent-8 model
        for name in written:
            a, sr = read_wav(os.path.join(out, name))
            if sr != 24000 or a.shape != (1, 7 * hop) or not np.isfinite(a).all():
                raise AssertionError(f"serve_batch {name}: {sr} Hz {a.shape}")
        launch = next(ln for ln in lines if ln.startswith("kernel launches "))
        got, steps = launch.removeprefix("kernel launches ").rsplit(" decode_steps ", 1)
        got, L = json.loads(got), cfg.llama.num_layers
        p11_check("serve_batch", got, {SIDEBAND: L * int(steps), "qmm": 4 * L * int(steps),
                                       "fused_mlp": L * int(steps)})
        log(f"  serve_batch: wavs in completion order {written}, each 7 x {hop} samples; "
            f"{json.loads(lines[-1])}")
        _add(counts, got)


def p11_micro(card: str, counts: dict) -> None:
    """(e) decode_microbench --int8 at batch 32, serve_profile at batch 8, 16
    and 32 (int8), train_microbench at b8 x t512 with remat none, full, dots."""
    from kalle_tpu_torch.tools import decode_microbench, serve_profile, train_microbench

    L = flagship_cfg().llama.num_layers
    per_step = {"weights": {"qmm": 4 * L, "fused_mlp": L},
                "step": {"decode_attention": L, "qmm": 4 * L, "fused_mlp": L},
                "step_nokv": {"decode_attention": L, "qmm": 4 * L, "fused_mlp": L}}

    def expect(out):
        total: dict = {}
        for x in out:
            steps = x["runs"] * (x["frames"] if x["variant"] == "gen" else 1)
            unit = per_step.get(x["variant"], per_step["step"])
            _add(total, {k: v * steps for k, v in unit.items()})
        return total

    lines, got = p11_counted("decode_microbench --int8 batch 32",
                             lambda: decode_microbench.main(["--int8", "--batch", "32",
                                                             "--steps", "32"]), expect)
    rows = {x["variant"]: x for x in lines}
    for x in lines:
        log(f"decode_micro {x['variant']} batch 32 int8 ms_per_step {x['ms_per_step']} "
            f"gb_per_s {x['gb_per_s']} bound_ms {x['bound_ms']} timing {x['timing']} "
            f"card {card}")
    log(f"  weights-only floor / step: {rows['weights']['ms_per_step'] / rows['step']['ms_per_step']:.3f} "
        f"(the layer matmuls' share of the whole step's device time)")
    _add(counts, got)
    for B in (8, 16, 32):
        line, got = p11_counted(
            f"serve_profile batch {B}",
            lambda: serve_profile.main(["--batch", str(B), "--steps", "64", "--int8"]),
            lambda out: {SIDEBAND: L * out["calls"], "qmm": 4 * L * out["calls"],
                         "fused_mlp": L * out["calls"]})
        log(f"serve_step batch {B} active {line['active_rows']} int8 ms_per_step "
            f"{line['ms_per_step']} (eager, ragged rows) card {card}")
        _add(counts, got)
    torch.cuda.empty_cache()
    from kalle_tpu_torch.ops.kernels import _build

    for spec in P11_TRAIN:
        _build.reset_launches()
        (line,) = train_microbench.main(["--configs", spec, "--iters", "5"])
        torch.cuda.synchronize()
        got, steps = _build.launches(), 1 + 5
        flash = [got.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
        # remat full and dots recompute the forward, K5 again, in the backward
        k5 = (2 if {"remat", "dots"} & set(spec.split(",")) else 1) * L * steps
        if flash != [k5, L * steps, L * steps] or any(got.get(k, 0)
                                                      for k in K1_K4 + (SIDEBAND,)):
            raise AssertionError(f"train_microbench {spec}: launches {got}")
        log(f"train_micro {spec} ms_per_step {line['ms_per_step']} tokens_per_s "
            f"{line['tokens_per_s']} mfu {line['mfu']} peak_mem_gb {line['peak_mem_gb']} "
            f"K5 a step {flash[0] // steps} card {card}")
        _add(counts, got)
        torch.cuda.empty_cache()


def p11_native(card: str) -> None:
    """(f) the native host library: the alignment against the Python one,
    the batch .npy reader against np.load, seconds of each."""
    from kalle_tpu_torch.eval import wer
    from kalle_tpu_torch.native import host

    if not host.have_compiler():
        raise AssertionError("no g++ on the card's host: the native path cannot be the one "
                             "that runs")
    t0 = time.perf_counter()
    host.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    pairs = [([str(x) for x in rng.integers(0, 30, rng.integers(20, 120))],
              [str(x) for x in rng.integers(0, 30, rng.integers(20, 120))])
             for _ in range(P11_NATIVE_PAIRS)]
    t0 = time.perf_counter()
    native = [wer._align(r, h) for r, h in pairs]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [wer._align_python(r, h) for r, h in pairs]
    python_s = time.perf_counter() - t0
    if native != python:
        raise AssertionError("align_tokens differs from _align_python")
    with tempfile.TemporaryDirectory() as root:
        meta = write_latents(root, P11_NATIVE_FILES)
        paths = [json.loads(x)["vae"] for x in open(meta)]
        t0 = time.perf_counter()
        got = host.load_npy_batch(paths)
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = [np.load(p) for p in paths]
        np_s = time.perf_counter() - t0
    if not all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, ref)):
        raise AssertionError("load_npy_batch differs from np.load")
    mb = sum(a.nbytes for a in ref) / 1e6
    log(f"native build_s {build_s:.2f} align {P11_NATIVE_PAIRS} pairs native_s {native_s:.4f} "
        f"python_s {python_s:.4f}; load_npy_batch {P11_NATIVE_FILES} files {mb:.1f} MB "
        f"native_s {batch_s:.4f} np_load_s {np_s:.4f} (warm page cache) card {card}")


def phase_tools(card: str) -> dict:
    """Phase 11: the port's tools at full width (kalle_tpu_torch/tools).
    Returns the launches of its counted runs."""
    log("# phase 11: tools — TTFA, open loop, HTTP, the experiment chain, serve_batch, "
        "microbenches, the native library")
    t0 = time.perf_counter()
    counts: dict = {}
    p11_latency(card, counts)
    torch.cuda.empty_cache()
    p11_http(card, counts)
    torch.cuda.empty_cache()
    p11_chain(card, counts)
    p11_serve_batch(card, counts)
    p11_micro(card, counts)
    p11_native(card)
    log(f"phase 11 s {time.perf_counter() - t0:.1f}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 on the card is compared at full precision: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    last = [t0]

    def lap(phase: str) -> None:  # each phase's wall seconds, for the time budget
        now = time.perf_counter()
        log(f"{phase} wall_s {now - last[0]:.1f}")
        last[0] = now

    phase_build()
    card = card_line()
    lap("phase 1")
    rows = phase_kernels()
    lap("phase 2")
    launches = phase_slice(card)
    phase_reference()
    lap("phase 3")
    with tempfile.TemporaryDirectory() as root:
        launches.update(phase_train(card, root))
    phase_train_reference()
    lap("phase 4")
    launches["decode_attention_sideband"] = phase_serve(card)["decode_attention_sideband"]
    lap("phase 5")
    k4, prompt_z = phase_infer(card)
    lap("phase 6")
    launches["convnext_block"] += k4
    p7 = phase_port_closure(card, prompt_z)
    lap("phase 7")
    for name in ("decode_attention", "convnext_block", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        launches[name] = launches.get(name, 0) + p7.get(name, 0)
    # the fused layout's rows: K2 and K3's fused mode in phase 7's fused generate runs
    launches["qmm_wqkv"], launches["fused_mlp_gu"] = p7["qmm"], p7["fused_mlp_gu"]
    p8 = phase_codecs(card)
    lap("phase 8")
    for name in ("decode_attention", "qmm", "fused_mlp", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        launches[name] = launches.get(name, 0) + p8.get(name, 0)
    p9 = phase_codec_training(card)
    lap("phase 9")
    for name in K1_K4:
        launches[name] = launches.get(name, 0) + p9.get(name, 0)
    p10 = phase_parallel(card)
    lap("phase 10")
    launches["decode_attention_sideband"] += p10.get("decode_attention_sideband", 0)
    for name in ("qmm", "fused_mlp", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        launches[name] = launches.get(name, 0) + p10.get(name, 0)
    p11 = phase_tools(card)
    lap("phase 11")
    for name in K_ALL:
        launches[name] = launches.get(name, 0) + p11.get(name, 0)
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
