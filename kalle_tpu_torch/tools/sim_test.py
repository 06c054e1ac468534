"""Speaker-similarity harness CLI of the port (counterpart of
tools/sim_test.py).

    python -m kalle_tpu_torch.tools.sim_test WAV_DIR --meta meta.lst \\
        [--ecapa-ckpt ecapa.pt | --no-train-synthetic] [--spk-steps 350] [--device cpu]

For every meta.lst row (`utt|prompt_text|prompt_wav|target_text`) with
both files, the cosine of the prompt wav's and `{utt}---gen.wav`'s
speaker embeddings (eval/harness.speaker_similarity): the per-utterance
values to `0000000_sim,json` (the reference's name, comma included) and
their mean to `0000000_sim.txt` in WAV_DIR. The embedder is the port's
ECAPA-TDNN over the mel frontend: from a torch ECAPA_TDNN state dict
(--ecapa-ckpt), else trained on synthetic speaker classification
(eval/speaker_embedder.py, the default), else random weights
(--no-train-synthetic; relative scores only). On the card unless --device
says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav_dir")
    ap.add_argument("--meta", required=True)
    ap.add_argument("--ecapa-ckpt", default="",
                    help="torch ECAPA_TDNN state_dict (backup/ecapa_tdnn.py)")
    ap.add_argument("--train-synthetic", action="store_true", default=None,
                    help="train the ECAPA on synthetic speaker classification first (the "
                         "default when no --ecapa-ckpt is given; --no-train-synthetic for "
                         "raw random weights)")
    ap.add_argument("--no-train-synthetic", dest="train_synthetic", action="store_false")
    ap.add_argument("--spk-steps", type=int, default=350)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..eval.harness import make_ecapa_embedder, read_meta_lst, speaker_similarity
    from ..models.conditioning.ecapa import EcapaConfig, init_params, params_from_state_dict
    from .common import device

    dev = device(args.device)
    meta = read_meta_lst(args.meta)
    if args.ecapa_ckpt:
        from ..models.lm.convert import load_torch_checkpoint

        ecfg = EcapaConfig()
        params = params_from_state_dict(load_torch_checkpoint(args.ecapa_ckpt), ecfg, dev)
        embed = make_ecapa_embedder(params, ecfg)
    elif args.train_synthetic is not False:
        # a discriminative embedder: a random ECAPA scores every pair ~0.99
        from ..eval import speaker_embedder as se

        cfg = dataclasses.replace(se.SpeakerTrainConfig(), steps=args.spk_steps)
        params, ecfg, _ = se.train_speaker_embedder(cfg, device=dev)
        pos, neg = se.margin(params, ecfg, cfg)
        print(f"trained synthetic embedder: heldout margin pos {pos:.3f} / neg {neg:.3f}")
        embed = se.make_trained_embedder(params, ecfg, cfg)
    else:
        print("WARNING: random ECAPA weights (relative scores only)")
        ecfg = EcapaConfig()
        embed = make_ecapa_embedder(
            init_params(ecfg, torch.Generator(device=dev).manual_seed(0), dev), ecfg)

    mean = speaker_similarity(args.wav_dir, meta, embed)
    print(f"mean speaker similarity: {mean:.4f}")
    return mean


if __name__ == "__main__":
    main()
