"""Batched sampling demo of the port (counterpart of tools/batch_infer.py):
one prompt repeated N times, a fixed number of decode steps (the end
detector off: `end_kl_threshold=-1`), the per-step end-KL trace printed.

    python -m kalle_tpu_torch.infer.batch_cli [--text T] [--repeats 5] \\
        [--steps 50] [--config cfg.yaml] [--checkpoint params.npz] \\
        [--chat-template] [--device cpu]

Without --config the model is the tiny test config with the byte
tokenizer; the batch runs as one KV-cached decode, on the card unless
--device says otherwise.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", default="a dog barking in the distance")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--config", default="")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--chat-template", action="store_true",
                    help="wrap the caption in the tokenizer's chat template instead "
                         "of the raw text + special-tokens prompt")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..core.checkpoint import load_llasa_params
    from ..core.config import LlasaConfig, load_experiment_config
    from ..data.tokens import build_chat_prompt_ids, build_prompt_ids, build_tokenizer
    from .generate import generate

    if args.config:
        exp = load_experiment_config(args.config)
        cfg = exp.model
        tokenizer = build_tokenizer(exp.tokenizer_path or None)
    else:
        cfg = LlasaConfig.tiny()
        tokenizer = build_tokenizer()
    params = load_llasa_params(args.checkpoint, cfg, args.device)

    build = build_chat_prompt_ids if args.chat_template else build_prompt_ids
    ids = torch.tensor([build(tokenizer, args.text)], device=args.device)
    batch_ids = ids.repeat(args.repeats, 1)
    res = generate(params, cfg, batch_ids, torch.ones_like(batch_ids),
                   torch.Generator(device=args.device).manual_seed(1),
                   max_frames=args.steps, end_kl_threshold=-1.0)
    kl = res.end_kl.cpu().numpy()
    for i in range(args.steps):
        print(f"step {i:3d}  end-KL " + " ".join(f"{kl[b, i]:.3f}" for b in range(args.repeats)))
    print("n_frames:", res.n_frames.tolist())


if __name__ == "__main__":
    main()
