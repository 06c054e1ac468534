"""VAE-GAN codec training: alternating generator and discriminator steps
(port of kalle_tpu/train/codec_trainer.py) for the three codecs, "sigma"
(SigmaVAE), "melvae" and "oobleck" (stereo Oobleck).

Generator loss: w_mrstft * MRSTFT (the stereo sum-and-difference STFT for
two channels) + w_l1 * L1 + w_mse * MSE + w_kl * KL, plus, once
`state.step >= warmup_steps`, w_adv * adversarial (LSGAN or hinge) +
w_fm * feature matching against `models/codecs/discriminators.py`.

PyTorch idiom: the params are dicts of f32 leaf tensors that require
grad; each side has one `torch.optim.AdamW` behind a `LambdaLR`, built by
`make_state` from a `CodecOptimizer` (`make_codec_optimizer`); the step
count is a host int and both steps update `state` in place. The warm-up
gate is a Python bool: before it the adversarial and feature-matching
terms are computed for the metrics but stay out of the total, which gives
the update of `gan_on=False` (no discriminator op at all).

Draws: the reconstruction's N(0, 1) (the sigma latent noise, the Oobleck
or mel-VAE posterior sample), then, with `latent_mask_ratio`, the mask's
U(0, 1), both of the latents' (B, T', d) shape, from `generator`; `noise`
and `mask_uniform` inject them (the JAX package draws `normal(rng)` and
`uniform(fold_in(rng, 1))` with rng = fold_in(key, step)).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..bridge import tree_leaves, tree_map
from ..core.checkpoint import copy_leaves_
from ..models.codecs import discriminators as disc
from ..models.codecs import melvae, oobleck, sigmavae
from .codec_losses import (
    discriminator_adv_loss,
    discriminator_hinge_loss,
    feature_matching_loss,
    generator_adv_loss,
    generator_hinge_loss,
    l1_time_loss,
    multi_resolution_stft_loss,
    sum_and_difference_stft_loss,
    vae_kl_loss,
)


@dataclasses.dataclass(frozen=True)
class LossWeights:
    mrstft: float = 1.0
    l1: float = 0.1
    mse: float = 0.0
    kl: float = 1e-4
    adv: float = 1.0
    fm: float = 2.0

    @staticmethod
    def oobleck_default() -> "LossWeights":
        """The reference wrapper's loss config for the Oobleck: mrstft 1.0,
        l1 0, adversarial 0.1, feature matching 5.0, kl 1e-6."""
        return LossWeights(mrstft=1.0, l1=0.0, mse=0.0, kl=1e-6, adv=0.1, fm=5.0)


def inverse_lr_schedule(base_lr: float, inv_gamma: float = 1.0, power: float = 1.0,
                        warmup: float = 0.0, final_lr: float = 0.0) -> Callable[[int], float]:
    """InverseLR's closed form: lr(t) = (1 - warmup**(t+1)) *
    max(final_lr, base_lr * (1 + t/inv_gamma)**-power)."""
    def schedule(step: int) -> float:
        w = 1.0 - warmup ** (step + 1.0)
        return w * max(final_lr, base_lr * (1.0 + step / inv_gamma) ** -power)

    return schedule


@dataclasses.dataclass(frozen=True)
class CodecOptimizer:
    """AdamW with optax's `adamw` defaults (eps 1e-8, weight decay 1e-4 on
    every leaf) and the codec betas; `schedule(n)` is the learning rate of
    update n (0-based), a constant `lr` when None. `build` makes the torch
    optimizer and its LambdaLR over a list of leaves."""
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    schedule: Optional[Callable[[int], float]] = None

    def lr_at(self, n: int) -> float:
        return self.lr if self.schedule is None else self.schedule(n)

    def build(self, leaves):
        opt = torch.optim.AdamW(leaves, lr=self.lr, betas=self.betas, eps=1e-8,
                                weight_decay=1e-4)
        scale = (lambda n: self.lr_at(n) / self.lr) if self.lr else (lambda n: 0.0)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, scale)


def make_codec_optimizer(lr: float = 1e-4, betas=(0.8, 0.99), use_inverse_lr: bool = False,
                         **sched_kwargs) -> CodecOptimizer:
    """The reference's codec optimizer: AdamW betas (0.8, 0.99), optionally
    under the InverseLR decay."""
    sched = inverse_lr_schedule(lr, **sched_kwargs) if use_inverse_lr else None
    return CodecOptimizer(lr=lr, betas=tuple(betas), schedule=sched)


@dataclasses.dataclass
class CodecTrainState:
    gen_params: dict
    disc_params: dict
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    gen_sched: torch.optim.lr_scheduler.LRScheduler
    disc_sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0  # generator updates made
    # EMA copy of gen_params (None = disabled), updated every generator step
    gen_ema: Optional[dict] = None

    def state_dict(self) -> dict:
        """What a checkpoint holds (core/checkpoint.CheckpointManager)."""
        return {"step": self.step, "gen_params": self.gen_params,
                "disc_params": self.disc_params, "gen_ema": self.gen_ema,
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "gen_sched": self.gen_sched.state_dict(),
                "disc_sched": self.disc_sched.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy a `state_dict` into this state's tensors and optimizers."""
        copy_leaves_(self.gen_params, sd["gen_params"], "checkpoint gen_params")
        copy_leaves_(self.disc_params, sd["disc_params"], "checkpoint disc_params")
        if self.gen_ema is not None:
            copy_leaves_(self.gen_ema, sd["gen_ema"], "checkpoint gen_ema")
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        self.gen_sched.load_state_dict(sd["gen_sched"])
        self.disc_sched.load_state_dict(sd["disc_sched"])
        self.step = int(sd["step"])


def make_state(gen_params: dict, disc_params: dict, gen_tx: CodecOptimizer,
               disc_tx: CodecOptimizer, use_ema: bool = False) -> CodecTrainState:
    """The params' leaves become trainable in place (requires_grad); the EMA
    starts as a copy of them."""
    opts = []
    for tree, tx in ((gen_params, gen_tx), (disc_params, disc_tx)):
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        opts.append(tx.build(leaves))
    ema = tree_map(lambda t: t.detach().clone(), gen_params) if use_ema else None
    return CodecTrainState(gen_params, disc_params, opts[0][0], opts[1][0], opts[0][1],
                           opts[1][1], 0, gen_ema=ema)


def ema_decay(step: int, beta: float = 0.9999, power: float = 0.75) -> float:
    """ema_pytorch's power schedule: clip(1 - (1+t)^-power, 0, beta)."""
    t = max(float(step), 0.0)
    return min(max(1.0 - (1.0 + t) ** -power, 0.0), beta)


def _draw(generator, like: torch.Tensor, given: Optional[torch.Tensor], uniform: bool):
    if given is not None:
        if tuple(given.shape) != tuple(like.shape):
            raise ValueError(f"injected draw {tuple(given.shape)} for {tuple(like.shape)}")
        return given.to(like.device, like.dtype)
    fn = torch.rand if uniform else torch.randn
    return fn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def _masked(z, ratio, generator, mask_uniform):
    if ratio <= 0.0:
        return z
    keep = _draw(generator, z, mask_uniform, uniform=True) >= ratio
    return torch.where(keep, z, torch.zeros_like(z))


def _reconstruct(kind: str, cfg, params: dict, wav: torch.Tensor,
                 generator: Optional[torch.Generator] = None, freeze_encoder: bool = False,
                 latent_mask_ratio: float = 0.0, noise: Optional[torch.Tensor] = None,
                 mask_uniform: Optional[torch.Tensor] = None):
    """-> (wav_hat, kl). wav (B, C, T). freeze_encoder stops gradients at
    the encoder's output; latent_mask_ratio zeroes that share of the
    latents before the decoder."""
    if kind == "melvae":
        wav_hat, (_, m_q, logs_q) = melvae.forward(
            params, cfg, wav, generator, freeze_encoder=freeze_encoder,
            latent_mask_ratio=latent_mask_ratio, noise=noise, mask_uniform=mask_uniform)
        return wav_hat, vae_kl_loss(m_q.transpose(1, 2), logs_q.transpose(1, 2))
    if kind == "sigma":
        z = sigmavae.encode_nwc(params, cfg, wav.transpose(1, 2))
        if freeze_encoder:
            z = z.detach()
        z_noised = z + cfg.sigma * _draw(generator, z, noise, uniform=False)
        z_noised = _masked(z_noised, latent_mask_ratio, generator, mask_uniform)
        wav_hat = sigmavae.decode_nwc(params, cfg, z_noised).transpose(1, 2)
        return wav_hat, (z * z).mean()  # the sigma-VAE's E||mean||^2
    if kind == "oobleck":
        # the patched pass-through bottleneck: mean||scale, scale used as the
        # stdev directly; KL summed over the latent channels, then meaned
        ms = oobleck.encode_nwc(params, cfg, wav.transpose(1, 2))
        if freeze_encoder:
            ms = ms.detach()
        d = ms.shape[-1] // 2
        mean, scale = ms[..., :d], ms[..., d:]
        z = mean + scale * _draw(generator, mean, noise, uniform=False)
        z = _masked(z, latent_mask_ratio, generator, mask_uniform)
        wav_hat = oobleck.decode_nwc(params, cfg, z).transpose(1, 2)
        var = scale * scale
        logvar = torch.log(var.clamp_min(1e-12))
        return wav_hat, (mean * mean + var - logvar - 1.0).sum(-1).mean()
    raise ValueError(kind)


def _apply(opt, sched, leaves, loss) -> None:
    """One optimizer update of `leaves` on d loss; a leaf the loss does not
    reach gets a zero gradient (optax's weight decay still applies)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    sched.step()
    opt.zero_grad(set_to_none=True)


def _detached(tree: dict) -> dict:
    return tree_map(lambda t: t.detach(), tree)


def generator_loss(gen_params: dict, disc_params: dict, kind: str, cfg, dcfg,
                   weights: LossWeights, wav: torch.Tensor,
                   generator: Optional[torch.Generator] = None, warmed: bool = True,
                   gan_on: bool = True, resolutions=None, freeze_encoder: bool = False,
                   latent_mask_ratio: float = 0.0, adv_type: str = "lsgan",
                   noise: Optional[torch.Tensor] = None,
                   mask_uniform: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's total loss (differentiable in gen_params only) and
    its metrics. With `gan_on` the adversarial and feature-matching terms
    are computed, and enter the total when `warmed`."""
    mr_kw = {} if resolutions is None else {"resolutions": resolutions}
    wav_hat, kl = _reconstruct(kind, cfg, gen_params, wav, generator,
                               freeze_encoder=freeze_encoder,
                               latent_mask_ratio=latent_mask_ratio, noise=noise,
                               mask_uniform=mask_uniform)
    t = min(wav.shape[-1], wav_hat.shape[-1])
    x, y = wav_hat[..., :t], wav[..., :t]
    if wav.shape[1] == 2:
        mr = sum_and_difference_stft_loss(x, y, **mr_kw)
    else:
        mr = multi_resolution_stft_loss(x[:, 0], y[:, 0], **mr_kw)
    l1 = l1_time_loss(x, y)
    mse = ((x - y) ** 2).mean()
    total = weights.mrstft * mr + weights.l1 * l1 + weights.mse * mse + weights.kl * kl
    if gan_on:
        dp = _detached(disc_params)
        fake_logits, fake_feats = disc.forward(dp, dcfg, x)
        with torch.no_grad():
            _, real_feats = disc.forward(dp, dcfg, y)
        adv = (generator_hinge_loss(fake_logits) if adv_type == "hinge"
               else generator_adv_loss(fake_logits))
        fm = feature_matching_loss(real_feats, fake_feats)
        if warmed:
            total = total + weights.adv * adv + weights.fm * fm
    else:
        adv = fm = total.new_zeros(())
    metrics = {"mrstft": mr, "l1": l1, "mse": mse, "kl": kl, "adv_g": adv, "fm": fm,
               "gen_total": total}
    return total, {k: v.detach() for k, v in metrics.items()}


def generator_step(state: CodecTrainState, kind: str, cfg, dcfg, weights: LossWeights,
                   wav: torch.Tensor, generator: Optional[torch.Generator] = None,
                   warmup_steps: int = 0, gan_on: bool = True, resolutions=None,
                   freeze_encoder: bool = False, latent_mask_ratio: float = 0.0,
                   adv_type: str = "lsgan", noise: Optional[torch.Tensor] = None,
                   mask_uniform: Optional[torch.Tensor] = None
                   ) -> Tuple[CodecTrainState, Dict[str, torch.Tensor]]:
    """One generator update, in place on `state`; returns (state, metrics)
    with the metrics as detached 0-d tensors. `gan_on=False` runs no
    discriminator op; `resolutions` overrides the MRSTFT bank."""
    total, metrics = generator_loss(
        state.gen_params, state.disc_params, kind, cfg, dcfg, weights, wav, generator,
        warmed=state.step >= warmup_steps, gan_on=gan_on, resolutions=resolutions,
        freeze_encoder=freeze_encoder, latent_mask_ratio=latent_mask_ratio, adv_type=adv_type,
        noise=noise, mask_uniform=mask_uniform)
    _apply(state.gen_opt, state.gen_sched, tree_leaves(state.gen_params), total)
    if state.gen_ema is not None:
        d = ema_decay(state.step)
        with torch.no_grad():
            for e, p in zip(tree_leaves(state.gen_ema), tree_leaves(state.gen_params)):
                e.add_(p - e, alpha=1.0 - d)
    state.step += 1
    return state, metrics


def discriminator_loss(gen_params: dict, disc_params: dict, kind: str, cfg, dcfg,
                       wav: torch.Tensor, generator: Optional[torch.Generator] = None,
                       adv_type: str = "lsgan",
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The discriminator's loss on `wav` and a reconstruction of it (one
    N(0, 1) draw, no mask, no gradient to the generator)."""
    with torch.no_grad():
        wav_hat, _ = _reconstruct(kind, cfg, gen_params, wav, generator, noise=noise)
    t = min(wav.shape[-1], wav_hat.shape[-1])
    real_logits, _ = disc.forward(disc_params, dcfg, wav[..., :t])
    fake_logits, _ = disc.forward(disc_params, dcfg, wav_hat[..., :t])
    if adv_type == "hinge":
        return discriminator_hinge_loss(real_logits, fake_logits)
    return discriminator_adv_loss(real_logits, fake_logits)


def discriminator_step(state: CodecTrainState, kind: str, cfg, dcfg, wav: torch.Tensor,
                       generator: Optional[torch.Generator] = None, adv_type: str = "lsgan",
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[CodecTrainState, Dict[str, torch.Tensor]]:
    """One discriminator update, in place on `state`; the step count does
    not advance."""
    loss = discriminator_loss(state.gen_params, state.disc_params, kind, cfg, dcfg, wav,
                              generator, adv_type=adv_type, noise=noise)
    _apply(state.disc_opt, state.disc_sched, tree_leaves(state.disc_params), loss)
    return state, {"adv_d": loss.detach()}
