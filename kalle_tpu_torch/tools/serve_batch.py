"""Continuous-batching synthesis CLI of the port (counterpart of
tools/serve_batch.py).

Reads a jsonl of {"id", "caption"} rows, admits them into the persistent
decode batch (infer/serve_loop.ContinuousBatcher) and writes each
utterance's wav the moment its row completes, so no request waits for the
whole batch; one line per wav in completion order, the hand-written
kernels' launch counts (empty on the CPU) with the batcher's decode steps,
then a JSON summary with the JAX tool's keys.

    python -m kalle_tpu_torch.tools.serve_batch -c cfg.yaml -i req.jsonl -o out \\
        [-p params.npz] [--batch 8] [-m 200] [--int8 | --int4] [--fused] [--int8-kv] \\
        [--stream CHUNK_FRAMES] [--device cpu]

Runs on the card unless --device says otherwise. Without -p the Llasa is a
random init (a save_params_npz file or a reference .pt / .safetensors
otherwise, as the inference CLI reads them); without --codec-config and
--codec-ckpt the codec is a random one. --int8 sends the decode's layer
matmuls through K2/K3 on the card, the batcher's attention is K1's
sideband mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--checkpoint", default="")
    ap.add_argument("-i", "--input-jsonl", required=True)
    ap.add_argument("-o", "--output-dir", default="serve_out")
    ap.add_argument("-m", "--max-frames", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--codec-kind", default="sigma", choices=["sigma", "stableaudio", "melvae"])
    ap.add_argument("--codec-config", default="")
    ap.add_argument("--codec-ckpt", default="")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--fused", action="store_true",
                    help="fused wqkv/wgu decode weight layout (wqkv through one K2 launch, "
                         "wgu through K3's fused mode)")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV cache with per-(token, head) scales: half the cache "
                         "memory (2x batch/context)")
    ap.add_argument("--int4", action="store_true",
                    help="int4 g128 weight-only LM decode (group-wise scales; the plain "
                         "group-wise route on every device)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only LM decode (K2/K3 on the card)")
    ap.add_argument("--stream", type=int, default=0, metavar="CHUNK_FRAMES",
                    help="stream each wav incrementally: sync every CHUNK_FRAMES decode "
                         "steps and append PCM chunks under an unbounded-size wav header "
                         "(serve/web.wav_chunk_header)")
    ap.add_argument("--stream-ctx", type=int, default=8,
                    help="left-context frames re-decoded per chunk to keep codec conv "
                         "state warm across chunk boundaries")
    args = ap.parse_args(argv)

    import numpy as np

    from ..core.checkpoint import load_llasa_params
    from ..core.config import load_experiment_config
    from ..data.datasets import read_jsonl
    from ..data.tokens import build_prompt_ids, build_tokenizer
    from ..infer.pipeline import Codec
    from ..infer.serve_loop import ContinuousBatcher
    from ..models.codecs.sigmavae import SigmaVAEConfig
    from ..utils.audio import write_wav
    from .common import device

    dev = device(args.device)
    exp = load_experiment_config(args.config)
    cfg = exp.model
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama,
                                                                 kv_cache_dtype="int8"))
    tok = build_tokenizer(exp.tokenizer_path or None)
    params = load_llasa_params(args.checkpoint, cfg, dev)
    if args.int8 or args.int4:
        from ..ops.quant import quantize_llama_params

        params = quantize_llama_params(params, bits=4 if args.int4 else 8)
    if args.fused:
        from ..ops.quant import fuse_decode_params

        params = fuse_decode_params(params)
    if args.codec_config and args.codec_ckpt:
        codec = Codec.load(args.codec_kind, args.codec_config, args.codec_ckpt, device=dev)
    else:
        print("WARNING: no codec checkpoint — random codec (smoke mode)")
        overrides = {}
        if args.codec_kind == "sigma" and cfg.latent_dim != 64:
            overrides["cfg"] = dataclasses.replace(SigmaVAEConfig.tiny(),
                                                   latent_dim=cfg.latent_dim)
        codec = Codec.random_init(args.codec_kind, device=dev, **overrides)

    rows = read_jsonl(args.input_jsonl)
    os.makedirs(args.output_dir, exist_ok=True)
    prompts, ids_of = [], []
    for i, row in enumerate(rows):
        text = str(row.get("caption") or row.get("AudioSetCaps") or row.get("text"))
        prompts.append(np.asarray(build_prompt_ids(tok, text), np.int32))
        ids_of.append(str(row.get("id", i)))

    cb = ContinuousBatcher(params, cfg, batch_size=args.batch, max_frames=args.max_frames,
                           device=dev)
    spf = codec.samples_per_frame
    sigma = cfg.head_variant == "sigma"
    t0 = time.perf_counter()
    n_done = 0

    if args.stream:
        from ..serve.web import wav_chunk_header

        files, bufs, ttfa = {}, {}, {}
        try:
            for ev, payload in cb.serve(prompts, chunk_frames=args.stream):
                if ev == "chunk":
                    ch = payload
                    if ch.index not in files:
                        path = os.path.join(args.output_dir, f"{ids_of[ch.index]}.wav")
                        files[ch.index] = open(path, "wb")
                        files[ch.index].write(wav_chunk_header(codec.sample_rate))
                        bufs[ch.index] = np.zeros((0, ch.means.shape[-1]), np.float32)
                        ttfa[ch.index] = time.perf_counter() - t0
                    bufs[ch.index] = np.concatenate([bufs[ch.index],
                                                     ch.samples if sigma else ch.means])
                    # re-decode with left context so the codec's receptive field
                    # spans the chunk boundary; emit only the new samples
                    lo = max(0, ch.start_frame - args.stream_ctx)
                    audio = codec.decode_latents(bufs[ch.index][None, lo:])
                    new = audio[0, :, (ch.start_frame - lo) * spf:]
                    pcm = np.clip(np.asarray(new[0], np.float32), -1, 1)
                    files[ch.index].write((pcm * 32767).astype("<i2").tobytes())
                else:
                    comp = payload
                    f = files.pop(comp.index, None)
                    if f:
                        f.close()
                    bufs.pop(comp.index, None)
                    n_done += 1
                    print(f"[{time.perf_counter() - t0:7.2f}s] {ids_of[comp.index]}.wav "
                          f"({comp.n_frames} frames, ttfa {ttfa.get(comp.index, 0.0):.2f}s)",
                          flush=True)
        finally:
            for f in files.values():
                f.close()
        wall = time.perf_counter() - t0
        summary = {"requests": n_done, "wall_s": round(wall, 2),
                   "req_per_s": round(n_done / wall, 3), "chunk_frames": args.stream}
        _report(cb, summary)
        return summary

    for comp in cb.run_iter(prompts):
        lat = comp.samples if sigma else comp.means
        audio = codec.decode_latents(lat[None])
        n = max(comp.n_frames, 1)
        path = os.path.join(args.output_dir, f"{ids_of[comp.index]}.wav")
        write_wav(path, audio[0, :, :n * spf], codec.sample_rate)
        n_done += 1
        print(f"[{time.perf_counter() - t0:7.2f}s] {path} "
              f"({comp.n_frames} frames, waited {comp.steps_waited} steps)", flush=True)
    wall = time.perf_counter() - t0
    summary = {"requests": n_done, "wall_s": round(wall, 2),
               "req_per_s": round(n_done / wall, 3)}
    _report(cb, summary)
    return summary


def _report(cb, summary: dict) -> None:
    """The kernels' launch counts and the batcher's decode steps, then the
    JAX tool's summary line (last)."""
    from ..ops.kernels import _build

    print(f"kernel launches {json.dumps(_build.launches())} decode_steps {cb.step_count}")
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
