"""Synthesis CLI of the port (counterpart of tools/infer.py).

    python -m kalle_tpu_torch.infer.cli -c cfg.yaml -i test.jsonl \\
        [-p params.npz] [-o out_root] [-m max_frames] [--limit N] [--device cpu]

For each jsonl row, writes {utt}.txt, {utt}---copysyn.wav and
{utt}---gen.wav through `InferTools.infer_jsonl` into
{out_root}/{project_name}-{checkpoint name}-{timestamp}, on the card unless
--device says otherwise. Without -p the Llasa is a random init. The codec
(--codec-kind sigma, stableaudio or melvae) loads from --codec-config and
--codec-ckpt (stableaudio: model_config.json and .safetensors / .pt;
melvae: h-config JSON and g_* checkpoint; sigma has no loader), else it is
a random one. Prints `wrote N files to DIR`, then the hand-written
kernels' launch counts.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--checkpoint", default="")
    ap.add_argument("-i", "--input-jsonl", required=True)
    ap.add_argument("-o", "--output-root", default="inference_results")
    ap.add_argument("-m", "--max-frames", type=int, default=200)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--codec-kind", default="sigma",
                    choices=["sigma", "stableaudio", "melvae"])
    ap.add_argument("--codec-config", default="")
    ap.add_argument("--codec-ckpt", default="")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.checkpoint import load_llasa_params
    from ..core.config import load_experiment_config
    from ..data.tokens import build_tokenizer
    from ..ops.kernels import _build
    from .pipeline import Codec, InferTools

    exp = load_experiment_config(args.config)
    tokenizer = build_tokenizer(exp.tokenizer_path or None)
    cfg = exp.model
    params = load_llasa_params(args.checkpoint, cfg, args.device, args.seed)
    if args.codec_config and args.codec_ckpt:
        codec = Codec.load(args.codec_kind, args.codec_config, args.codec_ckpt,
                           device=args.device)
    else:
        print("WARNING: no codec checkpoint — random codec (smoke mode)")
        extra = ({"encoder_out_dim": 2 * cfg.latent_dim}
                 if args.codec_kind == "stableaudio" else {})
        codec = Codec.random_init(args.codec_kind, device=args.device,
                                  latent_dim=cfg.latent_dim, **extra)

    it = InferTools(cfg, params, tokenizer, codec, output_root=args.output_root,
                    version=exp.project_name,
                    ckpt_name=os.path.basename(args.checkpoint) or "random",
                    seed=args.seed)
    files = it.infer_jsonl(args.input_jsonl, max_frames=args.max_frames, limit=args.limit)
    print(f"wrote {len(files)} files to {it.output_dir}")
    print("kernel launches " + json.dumps(_build.launches()))


if __name__ == "__main__":
    main()
