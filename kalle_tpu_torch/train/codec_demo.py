"""Codec training demonstration of the port (counterpart of
tools/train_codec_demo.py): train the sigma codec (mono 24 kHz) or the
stereo Oobleck from scratch on a synthesizable audio bank and report the
train-set and held-out copy-synthesis SNR and MRSTFT.

    python -m kalle_tpu_torch.train.codec_demo [--kind sigma|oobleck]
        [--steps 4000] [--size full|small] [--clips 48] [--holdout 12]
        [--gan] [--ema] [--ckpt DIR] [--out DIR] [--device cpu]

The bank is multi-speaker pseudo-speech (glottal pulse trains with a
wandering f0 through formant resonators), chirps, harmonic tones and AM
noise, made by numpy from fixed seeds. Without --gan the codec trains on
mse_weight * MSE + MRSTFT with Adam under a cosine decay; with --gan,
`train/codec_trainer.py`'s generator and discriminator steps (the
discriminator on odd steps once warmed up). Prints a JSON line every
--eval-every steps and, last, one JSON line with the JAX tool's keys:
{"snr_db", "mrstft", "holdout_snr_db", "holdout_mrstft", "steps", "size",
"gan", "kind", "warmup_steps", "clips", "holdout_clips", "wall_s"}.
Runs on the card unless --device says otherwise (the JAX tool's
--platform).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _formant_clip(rng, sr, t, kind):
    """One pseudo-speech or speech-adjacent clip (peak-normalised later)."""
    n = len(t)
    if kind == "speech":
        # glottal pulse train with a wandering f0, through 3 formants
        f0 = rng.uniform(85, 260)
        contour = f0 * (1 + 0.12 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                        + 0.06 * np.cumsum(rng.standard_normal(n)) / n)
        phase = 2 * np.pi * np.cumsum(contour) / sr
        pulses = np.maximum(np.sin(phase), 0.0) ** 6
        sig = pulses - pulses.mean()
        out = np.zeros(n)
        for lo, hi in ((300, 900), (900, 2400), (2400, 3500)):
            fc = rng.uniform(lo, hi)
            bw = rng.uniform(80, 240)
            r = np.exp(-np.pi * bw / sr)
            w = 2 * np.pi * fc / sr
            a1, a2 = 2 * r * np.cos(w), -r * r
            y = np.zeros(n)
            y1 = y2 = 0.0
            b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * w) + r * r)
            for j in range(n):  # 2-pole resonator
                y0 = b0 * sig[j] + a1 * y1 + a2 * y2
                y2, y1 = y1, y0
                y[j] = y0
            out += rng.uniform(0.5, 1.0) * y
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        return out + 0.05 * env * rng.standard_normal(n)
    if kind == "chirp":
        f0 = rng.uniform(100, 400)
        rate = rng.uniform(200, 1200)
        return np.sin(2 * np.pi * (f0 + 0.5 * rate * t) * t)
    if kind == "tones":
        f0 = rng.uniform(80, 500)
        sig = np.zeros(n)
        for h in range(1, 6):
            sig += rng.uniform(0.1, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 6.28))
        return sig
    # "noise": AM-shaped coloured noise
    am = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 8) * t)
    x = rng.standard_normal(n)
    return am * np.convolve(x, np.ones(8) / 8, mode="same")


def make_bank(sr: int, seconds: float, n: int, seed: int = 0) -> np.ndarray:
    """(n, T) f32: a deterministic bank, ~60% pseudo-speech, the rest split
    over chirps, tones and noise."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    kinds = ["speech"] * 3 + ["chirp", "tones", "noise"]
    clips = []
    for i in range(n):
        c = _formant_clip(rng, sr, t, kinds[i % len(kinds)])
        clips.append(0.8 * c / (np.abs(c).max() + 1e-9))
    return np.stack(clips).astype(np.float32)


def stereo_bank(bank: np.ndarray, sr: int) -> np.ndarray:
    """(N, T) mono -> (N, 2, T): the right channel is the left delayed by
    0.5 ms and attenuated, so both the sum and the difference are nonzero."""
    right = 0.9 * np.roll(bank, max(1, sr // 2000), axis=-1)
    return np.stack([bank, right], axis=1).astype(np.float32)


RESOLUTIONS = ((2048, 512, 2048), (1024, 256, 1024), (512, 128, 512))


def _codec(kind: str, size: str, device):
    """-> (cfg, params, samples a frame, audio channels) of `kind` at `size`."""
    from ..models.codecs import oobleck, sigmavae

    g = torch.Generator(device=device).manual_seed(0)
    if kind == "sigma":
        cfg = (sigmavae.SigmaVAEConfig() if size == "full" else sigmavae.SigmaVAEConfig(
            latent_dim=16, strides=(2, 2), channels=(16, 32), blocks_per_stage=1))
        return cfg, sigmavae.init_params(cfg, g, device), cfg.hop, 1
    cfg = (oobleck.OobleckConfig() if size == "full" else oobleck.OobleckConfig(
        channels=8, latent_dim=8, encoder_out_dim=16, c_mults=(1, 2), strides=(2, 4),
        sample_rate=16000))
    return cfg, oobleck.init_params(cfg, g, device), cfg.downsampling_ratio, cfg.io_channels


def copysyn(kind: str, cfg, params: dict, wav: torch.Tensor) -> torch.Tensor:
    """The differentiable encode -> decode of wav (B, C, T); the Oobleck's
    through the mean of its mean||scale latents, divided by the
    pretransform's scale on the way in and multiplied on the way out."""
    from ..models.codecs import oobleck, sigmavae

    if kind == "sigma":
        z = sigmavae.encode_nwc(params, cfg, wav.transpose(1, 2))
        return sigmavae.decode_nwc(params, cfg, z).transpose(1, 2)
    ms = oobleck.encode_nwc(params, cfg, wav.transpose(1, 2)) / cfg.scale
    z = ms[..., :ms.shape[-1] // 2] * cfg.scale
    return oobleck.decode_nwc(params, cfg, z).transpose(1, 2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", default="sigma", choices=["sigma", "oobleck"],
                    help="sigma: mono 24 kHz sigma-VAE (LSGAN MPD+MRD); oobleck: "
                         "stereo Oobleck (hinge, Encodec-style scales, mid/side MRSTFT)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--size", default="full", choices=["full", "small"])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--clips", type=int, default=48, help="training clips")
    ap.add_argument("--holdout", type=int, default=12,
                    help="held-out clips (same distribution, disjoint seed)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--mse-weight", type=float, default=50.0)
    ap.add_argument("--gan", action="store_true",
                    help="VAE-GAN training: MRSTFT + MSE + KL + adversarial + feature "
                         "matching against MPD+MRD discriminators (train/codec_trainer.py)")
    ap.add_argument("--adv-weight", type=float, default=0.1)
    ap.add_argument("--fm-weight", type=float, default=2.0)
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="recon-only generator steps before the adversarial terms and "
                         "the discriminator start (default steps//2)")
    ap.add_argument("--disc-lr", type=float, default=None,
                    help="discriminator lr (default: --lr)")
    ap.add_argument("--ema", action="store_true",
                    help="keep an EMA of the generator (beta 0.9999, power 3/4); eval "
                         "and export use it")
    ap.add_argument("--freeze-encoder-on-warmup", action="store_true",
                    help="stop encoder gradients once warmed up")
    ap.add_argument("--latent-mask", type=float, default=0.0,
                    help="zero this share of latents before decode")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir for the GAN arm: the whole CodecTrainState "
                         "(both params and optimizer states) every eval; resumes from "
                         "the newest")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = args.device

    from ..train.codec_losses import multi_resolution_stft_loss, sum_and_difference_stft_loss
    from ..train.optim import adam_cosine

    cfg, params, ratio, channels = _codec(args.kind, args.size, device)
    train_bank = make_bank(cfg.sample_rate, args.seconds, args.clips, seed=0)
    held_bank = make_bank(cfg.sample_rate, args.seconds, args.holdout, seed=777)
    T = (train_bank.shape[-1] // ratio) * ratio
    if channels == 2:
        train_np = stereo_bank(train_bank, cfg.sample_rate)[..., :T]
        held_np = stereo_bank(held_bank, cfg.sample_rate)[..., :T]
    else:
        train_np, held_np = train_bank[:, None, :T], held_bank[:, None, :T]
    train = torch.from_numpy(np.ascontiguousarray(train_np)).to(device)
    held = torch.from_numpy(np.ascontiguousarray(held_np)).to(device)

    def mr_loss(x, y):
        if channels == 2:
            return sum_and_difference_stft_loss(x, y, resolutions=RESOLUTIONS)
        return multi_resolution_stft_loss(x[:, 0], y[:, 0], resolutions=RESOLUTIONS)

    @torch.no_grad()
    def metrics(p, wav):
        y = copysyn(args.kind, cfg, p, wav)
        snr = 10.0 * torch.log10((wav ** 2).mean() / (((y - wav) ** 2).mean() + 1e-12))
        return float(snr), float(mr_loss(y, wav))

    def row(i, p, extra):
        tr_snr, tr_mr = metrics(p, train)
        ho_snr, ho_mr = metrics(p, held)
        r = {"step": i, "train_snr_db": round(tr_snr, 2), "train_mrstft": round(tr_mr, 4),
             "holdout_snr_db": round(ho_snr, 2), "holdout_mrstft": round(ho_mr, 4)}
        r.update(extra)
        r["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(r), flush=True)
        return r

    rng = np.random.default_rng(1)
    traj = []
    t0 = time.time()
    warmup = args.steps // 2 if args.warmup_steps is None else args.warmup_steps
    if args.gan:
        from ..models.codecs import discriminators as disc_mod
        from . import codec_trainer as ct

        if args.kind == "oobleck":
            dcfg = (disc_mod.DiscriminatorConfig.encodec_stereo() if args.size == "full"
                    else disc_mod.DiscriminatorConfig.tiny(in_channels=2))
            adv_type = "hinge"
        else:
            dcfg = (disc_mod.DiscriminatorConfig() if args.size == "full"
                    else disc_mod.DiscriminatorConfig.tiny())
            adv_type = "lsgan"
        # the recon-only arm's objective (mse_weight * MSE + MRSTFT) plus the GAN terms
        weights = ct.LossWeights(mrstft=1.0, l1=0.0, mse=args.mse_weight, kl=1e-4,
                                 adv=args.adv_weight, fm=args.fm_weight)
        state = ct.make_state(
            params, disc_mod.init_params(dcfg, torch.Generator(device=device).manual_seed(2),
                                         device),
            ct.make_codec_optimizer(args.lr), ct.make_codec_optimizer(args.disc_lr or args.lr),
            use_ema=args.ema)
        gen = torch.Generator(device=device).manual_seed(3)
        dm = {"adv_d": float("nan")}
        use_adv = bool(args.adv_weight or args.fm_weight)
        mgr, start = None, 0
        if args.ckpt:
            from ..core.checkpoint import CheckpointManager

            mgr = CheckpointManager(args.ckpt)
            state, start = mgr.restore(state)
            if start:
                rng = np.random.default_rng([1, start])
                print(f"# resumed step {start} from {args.ckpt}", flush=True)
        for i in range(start, args.steps):
            idx = rng.choice(len(train_bank), args.batch, replace=args.batch > len(train_bank))
            wav = train[torch.from_numpy(idx).to(device)]
            gan_on = use_adv and i >= warmup
            if gan_on and i % 2:
                state, dm = ct.discriminator_step(state, args.kind, cfg, dcfg, wav, gen,
                                                  adv_type=adv_type)
            state, gm = ct.generator_step(
                state, args.kind, cfg, dcfg, weights, wav, gen, warmup_steps=warmup,
                gan_on=gan_on, resolutions=RESOLUTIONS,
                freeze_encoder=args.freeze_encoder_on_warmup and gan_on,
                latent_mask_ratio=args.latent_mask, adv_type=adv_type)
            params = state.gen_ema if state.gen_ema is not None else state.gen_params
            if i % args.eval_every == 0 or i == args.steps - 1:
                traj.append(row(i, params, {"adv_d": round(float(dm["adv_d"]), 4),
                                            "adv_g": round(float(gm["adv_g"]), 4),
                                            "fm": round(float(gm["fm"]), 4)}))
                if mgr is not None:
                    mgr.save(i + 1, state, wait=True)
        if mgr is not None:
            mgr.close()
    else:
        from ..bridge import tree_leaves

        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt, sched = adam_cosine(leaves, args.lr, args.steps, 0.02)
        for i in range(args.steps):
            idx = rng.choice(len(train_bank), args.batch, replace=args.batch > len(train_bank))
            wav = train[torch.from_numpy(idx).to(device)]
            y = copysyn(args.kind, cfg, params, wav)
            loss = args.mse_weight * ((y - wav) ** 2).mean() + mr_loss(y, wav)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
            if i % args.eval_every == 0 or i == args.steps - 1:
                traj.append(row(i, params, {}))

    tr_snr, tr_mr = metrics(params, train)
    ho_snr, ho_mr = metrics(params, held)
    if args.out:
        from ..core.checkpoint import save_params_npz
        from ..utils.audio import write_wav

        os.makedirs(args.out, exist_ok=True)
        save_params_npz(os.path.join(args.out, f"{args.kind}vae_demo.npz"), params)
        with torch.no_grad():
            y = copysyn(args.kind, cfg, params, held[:1])
        write_wav(os.path.join(args.out, "holdout_copysyn0.wav"), y[0].cpu().numpy(),
                  cfg.sample_rate)
        write_wav(os.path.join(args.out, "holdout_gt0.wav"), held[0].cpu().numpy(),
                  cfg.sample_rate)
        with open(os.path.join(args.out, "trajectory.jsonl"), "w") as f:
            for r in traj:
                f.write(json.dumps(r) + "\n")
    result = {"snr_db": round(tr_snr, 2), "mrstft": round(tr_mr, 4),
              "holdout_snr_db": round(ho_snr, 2), "holdout_mrstft": round(ho_mr, 4),
              "steps": args.steps, "size": args.size, "gan": args.gan, "kind": args.kind,
              "warmup_steps": warmup if args.gan else None, "clips": args.clips,
              "holdout_clips": args.holdout, "wall_s": round(time.time() - t0, 1)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
