"""Serving latency benchmark of the port (counterpart of
tools/latency_bench.py): time to first audio (TTFA) and end-to-end RTF
including the codec decode.

TTFA = prefill + `--chunk-frames` frames through `generate` + the codec
decode of that chunk (streaming playback can start once the first chunk
exists), timed on the host clock around work that ends on the host (the
decoded audio is copied off the device). Modes:

  (default)       p50 / p95 TTFA at --batch, then RTF with the codec over
                  --max-frames frames
  --continuous N  the batch-size curve: N requests through
                  infer.serve_loop.ContinuousBatcher at batch 1/2/4/8/16
  --poisson R,..  open-loop arrivals: --continuous N requests (default 32)
                  with exponential inter-arrival times at each rate through
                  ContinuousBatcher.serve, p50/p95 TTFA and end-to-end
  --interleave    infer/streaming.stream_generate (delay-frame warm-up
                  latents from silence, the speaker VAE's frame, lockstep
                  decode) at --batch

    python -m kalle_tpu_torch.tools.latency_bench --tiny --device cpu --iters 2
    python -m kalle_tpu_torch.tools.latency_bench --batch 1 --iters 10   (the card)

Full width is the flagship (core/config.flagship_cfg: Llama-3.2-1B widths,
sigma head, 64-d latents) with random bf16 weights from a seeded
torch.Generator and the default SigmaVAE in bf16, so its residual blocks
run K4 on the card; the decode attention is K1 (its sideband mode in the
batcher). --tiny is the test config in f32. Prints one JSON line per
metric with the JAX tool's keys; `main` returns them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

PROMPT_BUCKETS = (16, 32, 64)


def build(tiny: bool, dev: torch.device, seed: int = 0):
    """(cfg, params, codec) at the bench's width on `dev`: tiny in f32, or
    the flagship and the default SigmaVAE in bf16."""
    from ..bridge import tree_map
    from ..core.config import LlasaConfig, flagship_cfg
    from ..infer.pipeline import Codec
    from ..models.codecs.sigmavae import SigmaVAEConfig
    from ..models.lm import llasa

    g = torch.Generator(device=dev).manual_seed(seed)
    if tiny:
        codec = Codec.random_init("sigma", g, dev, cfg=SigmaVAEConfig.tiny())
        cfg = LlasaConfig.tiny()
        cfg = LlasaConfig(llama=cfg.llama, latent_dim=codec.cfg.latent_dim,
                          audio_proj_dim=cfg.audio_proj_dim)
        return cfg, llasa.init_params(cfg, g, dev), codec
    cfg = flagship_cfg()
    codec = Codec.random_init("sigma", g, dev).astype(torch.bfloat16)
    params = tree_map(lambda t: t.to(torch.bfloat16), llasa.init_params(cfg, g, dev))
    return cfg, params, codec


def _emit(out: list, line: dict, **unprinted) -> None:
    """Print `line`; keep it in `out` with `unprinted` (the decode steps a
    run took, for callers that check the kernels' launch counts)."""
    print(json.dumps(line), flush=True)
    out.append({**line, **unprinted})


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--chunk-frames", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="continuous-batching curve: N requests through "
                         "infer.serve_loop at batch sizes 1/2/4/8/16")
    ap.add_argument("--kernel-min-batch", type=int, default=None,
                    help="the JAX package's decode-attention batch gate; the port has "
                         "none (K1 runs at every batch on the card), so giving it raises")
    ap.add_argument("--poisson", default="", metavar="RATES",
                    help="open-loop SLO bench: comma-separated arrival rates (req/s); "
                         "each rate serves --continuous N requests (default 32) with "
                         "exponential inter-arrivals through ContinuousBatcher.serve "
                         "and reports p50/p95 TTFA + e2e under load")
    ap.add_argument("--serve-batch", type=int, default=8,
                    help="decode batch for the --poisson server")
    ap.add_argument("--interleave", action="store_true",
                    help="benchmark the text/audio streaming-interleave mode "
                         "(infer/streaming.stream_generate) instead of batch decode")
    ap.add_argument("--delay-frames", type=int, default=3,
                    help="interleave mode: audio stream delay in frames")
    args = ap.parse_args(argv)
    if args.kernel_min_batch is not None:
        raise ValueError("--kernel-min-batch: the port has no decode-attention batch gate; "
                         "K1 runs at every batch on the card")

    from ..infer.generate import generate
    from ..infer.serve_loop import ContinuousBatcher
    from .common import device, pct, sync

    dev = device(args.device)
    cfg, params, codec = build(args.tiny, dev)
    rng = np.random.default_rng(0)
    frame_hz = codec.cfg.frame_rate
    out: list = []

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if args.interleave:
        from ..bridge import tree_map
        from ..infer.streaming import sample_speaker_cond, stream_generate
        from ..models.lm import variants

        cfg = dataclasses.replace(cfg, head_variant="stableaudio")
        vparams = variants.init_variant_params(cfg, gen(0), speaker_vae=True, device=dev)
        dt = params["audio_linear"]["w"].dtype
        vparams = tree_map(lambda t: t.to(dt), vparams)
        B = args.batch
        t_text = 64  # fixed pad length (ref infer_stream.py:447)
        ids = torch.from_numpy(rng.integers(0, cfg.llama.vocab_size - 9, (B, t_text))).to(dev)
        # delay warm-up: silence through the codec's encoder, its means
        n = int(round(args.delay_frames * codec.cfg.sample_rate / frame_hz))
        warm = torch.from_numpy(codec.encode_audio(np.zeros((B, n), np.float32))
                                [:, :args.delay_frames]).to(dev, dt)
        spk = sample_speaker_cond(vparams, gen(1), cfg.audio_proj_dim, device=dev
                                  ).to(dt).expand(B, -1)

        def chunk(seed, steps):
            res = stream_generate(vparams, cfg, ids, warm, spk, gen(seed), max_steps=steps,
                                  end_kl_threshold=-1.0)
            return codec.decode_latents(res.samples)

        chunk(1, args.chunk_frames)  # warm-up
        chunk(1, args.max_frames)
        ttfas = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            chunk(2 + i, args.chunk_frames)
            ttfas.append(time.perf_counter() - t0)
        n_full = max(args.iters // 2, 1)
        t0 = time.perf_counter()
        for i in range(n_full):
            chunk(100 + i, args.max_frames)
        dt_full = (time.perf_counter() - t0) / n_full
        rtf = dt_full / (B * args.max_frames / frame_hz)
        _emit(out, {
            "metric": "interleave_p50_ttfa_s", "value": pct(ttfas, 0.5, 4),
            "p95": pct(ttfas, 0.95, 4),
            "unit": f"s (batch={B}, delay={args.delay_frames}fr, {args.chunk_frames}fr = "
                    f"{args.chunk_frames / frame_hz:.2f}s chunk)"})
        _emit(out, {"metric": "interleave_rtf_incl_codec", "value": round(rtf, 6),
                    "unit": f"wall_s_per_audio_s (batch={B})",
                    "vs_baseline": round(0.1 / rtf, 2)})
        return out

    def requests(n):
        lens = rng.integers(8, 60, (n,))
        return [rng.integers(0, cfg.llama.vocab_size - 9, (n_,)).astype(np.int32)
                for n_ in lens]

    def batcher(bsz):
        return ContinuousBatcher(params, cfg, batch_size=bsz, max_frames=args.max_frames,
                                 prompt_buckets=PROMPT_BUCKETS, device=dev)

    if args.poisson:
        n_req = args.continuous or 32
        prompts = requests(n_req)
        bsz = args.serve_batch
        warm = batcher(bsz)
        warm.run(prompts[:bsz])  # warm-up
        for rate in (float(r) for r in args.poisson.split(",")):
            arrivals = np.cumsum(rng.exponential(1.0 / rate, n_req)).tolist()
            cb = batcher(bsz)
            ttfa, e2e = {}, {}
            t0 = time.perf_counter()
            for ev, p in cb.serve(prompts, arrivals=arrivals, chunk_frames=args.chunk_frames):
                now = time.perf_counter() - t0
                if ev == "chunk" and p.index not in ttfa:
                    ttfa[p.index] = now - arrivals[p.index]
                elif ev == "done":
                    e2e[p.index] = now - arrivals[p.index]
            wall = time.perf_counter() - t0
            _emit(out, {
                "metric": "poisson_slo", "rate_req_s": rate, "batch": bsz,
                "requests": n_req, "wall_s": round(wall, 2),
                "p50_ttfa_s": pct(ttfa.values(), 0.5), "p95_ttfa_s": pct(ttfa.values(), 0.95),
                "p50_e2e_s": pct(e2e.values(), 0.5), "p95_e2e_s": pct(e2e.values(), 0.95),
                "chunk_frames": args.chunk_frames},
                decode_steps=cb.step_count + (warm.step_count if not out else 0))
        return out

    if args.continuous:
        n_req = args.continuous
        prompts = requests(n_req)
        for bsz in (1, 2, 4, 8, 16):
            warm = batcher(bsz)
            warm.run(prompts[:bsz])  # warm-up
            cb = batcher(bsz)
            t0 = time.perf_counter()
            comps = cb.run(prompts)
            wall = time.perf_counter() - t0
            step_s = wall / max(cb.step_count, 1)
            lats = [c.steps_waited * step_s for c in comps]
            frames = sum(c.n_frames for c in comps)
            _emit(out, {
                "metric": "continuous_batching", "batch": bsz, "requests": n_req,
                "req_per_s": round(n_req / wall, 3),
                "frames_per_s": round(frames / wall, 1),
                "audio_s_per_wall_s": round(frames / frame_hz / wall, 3),
                "p50_latency_s": pct(lats, 0.5), "p95_latency_s": pct(lats, 0.95)},
                decode_steps=cb.step_count + warm.step_count)
        return out

    B = args.batch
    ids = torch.from_numpy(rng.integers(0, cfg.llama.vocab_size - 9, (B, 32))).to(dev)
    mask = torch.ones((B, 32), dtype=torch.int32, device=dev)

    def decode(seed, frames):
        res = generate(params, cfg, ids, mask, gen(seed), max_frames=frames,
                       end_kl_threshold=-1.0)
        return codec.decode_latents(res.samples)  # host audio: the device is done

    decode(1, args.chunk_frames)  # warm-up
    decode(1, args.max_frames)
    ttfas = []
    for i in range(args.iters):
        t0 = time.perf_counter()
        decode(2 + i, args.chunk_frames)
        ttfas.append(time.perf_counter() - t0)
    n_full = max(args.iters // 2, 1)
    t0 = time.perf_counter()
    for i in range(n_full):
        decode(100 + i, args.max_frames)
    sync(dev)
    dt_full = (time.perf_counter() - t0) / n_full
    rtf = dt_full / (B * args.max_frames / frame_hz)
    _emit(out, {"metric": "p50_time_to_first_audio_s", "value": pct(ttfas, 0.5, 4),
                "p95": pct(ttfas, 0.95, 4),
                "unit": f"s (batch={B}, {args.chunk_frames} frames "
                        f"= {args.chunk_frames / frame_hz:.2f}s chunk)"})
    _emit(out, {"metric": "e2e_rtf_incl_codec", "value": round(rtf, 6),
                "unit": f"wall_s_per_audio_s (batch={B})", "vs_baseline": round(0.1 / rtf, 2)})
    return out


if __name__ == "__main__":
    main()
