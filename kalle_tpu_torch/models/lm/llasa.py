"""Llasa: the continuous-latent audio LM (port of
kalle_tpu/models/lm/llasa.py:46-214).

A Llama backbone plus `audio_linear` (latent_dim -> audio_proj_dim input
projection) and `distribution_linear` (Linear -> exact GELU -> Linear
head emitting the next frame's latent distribution). Three head variants:
  "sigma":       head -> mean; sigma fixed 0.5; input latents are noised
                 before embedding; loss KL(pred || label);
  "stableaudio": head -> mean||log_scale; labels mean||scale with the
                 label std x1.25; loss KL(label || pred);
  "melvae":      head -> mean||log_scale; labels mean||log_scale; loss
                 KL(label || pred).
Sequence packing: one row per sample, [text ids][audio frames], merged by
elementwise masks, attention over the union.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.config import LlasaConfig, torch_dtype
from . import llama
from .losses import gaussian_kl, gaussian_kl_same_std, masked_frame_loss, split_mean_scale_btd


def init_params(cfg: LlasaConfig, generator: torch.Generator, device="cuda") -> dict:
    """Backbone init from llama.init_params; the heads get uniform(±fan_in^-½)
    weights and biases, in f32."""
    d, p, o = cfg.latent_dim, cfg.audio_proj_dim, cfg.head_out_dim

    def lin(fan_in, fan_out):
        bound = fan_in ** -0.5

        def u(*shape):
            r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return r * (2 * bound) - bound

        return u(fan_in, fan_out), u(fan_out)

    backbone = llama.init_params(cfg.llama, generator, device)
    aw, ab = lin(d, p)
    w0, b0 = lin(p, o)
    w2, b2 = lin(o, o)
    return {"llama": backbone,
            "audio_linear": {"w": aw, "b": ab},
            "distribution_linear": {"w0": w0, "b0": b0, "w2": w2, "b2": b2}}


def audio_proj(params: dict, latents: torch.Tensor, dtype) -> torch.Tensor:
    al = params["audio_linear"]
    return latents.to(dtype) @ al["w"].to(dtype) + al["b"].to(dtype)


def distribution_head(params: dict, hidden: torch.Tensor, dtype) -> torch.Tensor:
    dl = params["distribution_linear"]
    x = hidden @ dl["w0"].to(dtype) + dl["b0"].to(dtype)
    x = F.gelu(x, approximate="none")
    return x @ dl["w2"].to(dtype) + dl["b2"].to(dtype)


def end_kl(cfg: LlasaConfig, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Per-frame KL(N(mean, std) || N(end_mean, end_std)) / d, in f32 — the
    end-of-speech test statistic."""
    m1, s1 = mean.float(), std.float()
    # the end distribution's parameters take mean's dtype first, as in JAX
    m2 = torch.full_like(mean, cfg.end_mean).float()
    s2 = torch.full_like(mean, cfg.end_std).float()
    kl = torch.log(s2 / s1) + (s1 * s1 + (m1 - m2) ** 2) / (2.0 * s2 * s2) - 0.5
    return kl.sum(dim=-1) / cfg.latent_dim


def sample_fix(generator: torch.Generator, mean: torch.Tensor, std: float) -> torch.Tensor:
    """sigma-VAE 'fix' sampling: mean + std * N(0, 1), drawn in f32 from
    `generator` (on mean's device) and cast to mean's dtype."""
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=torch.float32)
    return mean + std * noise.to(mean.dtype)


def sample_gaussian(generator: torch.Generator, mean: torch.Tensor, std: float) -> torch.Tensor:
    """sigma-VAE 'gaussian' sampling: a random std a row, N(0, 1) *
    std / 0.8, times N(0, 1) noise a value, added to mean; both drawn in f32
    from `generator` (on mean's device), cast to mean's dtype."""
    b = mean.shape[0]

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=mean.device,
                           dtype=torch.float32).to(mean.dtype)

    per_row = (normal(b) * (std / 0.8)).reshape((b,) + (1,) * (mean.dim() - 1))
    return mean + per_row * normal(*mean.shape)


def embed_inputs(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 latent_noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed-row input embeddings: token embeds and projected audio
    latents merged by the masks. Returns (input_embed (b, t, h),
    attention_mask (b, t) int32, latents — after the noise for sigma)."""
    dt = torch_dtype(cfg.llama.dtype)
    latents = batch["audio_latents"]
    ids_mask = batch["ids_mask"].to(dt)
    audio_mask = batch["audio_mask"].to(dt)
    text_embed = llama.embed_tokens(params["llama"], batch["input_ids"], cfg.llama)
    if cfg.head_variant == "sigma":
        # input latents are noised before embedding; latent_noise injects a
        # fixed N(0, 1) draw (replay, parity tests), else the generator draws
        if latent_noise is not None:
            latents = latents.to(dt) + cfg.sigma * latent_noise.to(dt)
        elif generator is not None:
            latents = sample_fix(generator, latents.to(dt), cfg.sigma)
        else:
            raise ValueError("sigma variant requires a generator or latent_noise")
    audio_embed = audio_proj(params, latents, dt)
    input_embed = audio_embed * audio_mask[..., None] + text_embed * ids_mask[..., None]
    attention_mask = (batch["ids_mask"].to(torch.int32)
                      + batch["audio_mask"].to(torch.int32))
    return input_embed, attention_mask, latents


def head_kl(params: dict, cfg: LlasaConfig, hidden: torch.Tensor, labels: torch.Tensor):
    """Distribution head + per-element KL for the configured variant.
    Returns (kl_elem (b, t, d), pre_mean, pre_log_scale)."""
    dt = torch_dtype(cfg.llama.dtype)
    head_out = distribution_head(params, hidden, dt)
    if cfg.head_variant == "sigma":
        mean2 = head_out
        kl_elem = gaussian_kl_same_std(mean2, cfg.sigma, labels)  # KL(pred || label)
        pre_log_scale = torch.full_like(mean2, math.log(cfg.sigma))
    elif cfg.head_variant in ("stableaudio", "melvae"):
        mean2, logs2 = split_mean_scale_btd(head_out)
        mean1, s1 = split_mean_scale_btd(labels)
        std1 = (s1 * cfg.label_std_scale if cfg.head_variant == "stableaudio"
                else torch.exp(s1))
        kl_elem = gaussian_kl(mean1, std1, mean2, torch.exp(logs2))  # KL(label || pred)
        pre_log_scale = logs2
    else:
        raise ValueError(f"unknown head_variant {cfg.head_variant}")
    return kl_elem, mean2, pre_log_scale


def _head_losses(params: dict, cfg: LlasaConfig, hidden: torch.Tensor,
                 batch: Dict[str, torch.Tensor], latents: torch.Tensor, counts=None):
    kl_elem, mean2, pre_log_scale = head_kl(params, cfg, hidden, batch["distribute_labels"])
    audio_loss, end_loss = masked_frame_loss(kl_elem, cfg.latent_dim,
                                             batch["target_mask"], batch["end_mask"], counts)
    extras = ({"ground_truth_audio_latents": latents}
              if cfg.head_variant == "sigma" else {})
    return {"audio_loss": audio_loss, "end_loss": end_loss, "pre_mean": mean2,
            "pre_log_scale": pre_log_scale, **extras}


def forward(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None,
            latent_noise: Optional[torch.Tensor] = None,
            use_flash: Optional[bool] = None, layout=None) -> Dict[str, torch.Tensor]:
    """Training forward over a collated batch (input_ids (b, t);
    audio_latents (b, t, d); distribute_labels (b, t, d or 2d); ids_mask,
    audio_mask, target_mask, end_mask (b, t)). Returns audio_loss,
    end_loss, pre_mean, pre_log_scale (+ the noised latents for sigma).

    layout (parallel.mesh.Layout): the batch is this dp rank's rows and the
    params its shards. The losses are then this rank's shares of the
    global batch's: masked sums over its rows (and its slice of t under
    sp) divided by the global mask counts, so the shares sum (over dp and
    sp) to the single-process losses; the other outputs cover its rows
    (and slice)."""
    input_embed, attention_mask, latents = embed_inputs(
        params, cfg, batch, generator=generator, latent_noise=latent_noise)
    hidden = llama.forward(params["llama"], cfg.llama, input_embed, attention_mask,
                           use_flash=use_flash, layout=layout)
    counts = None
    if layout is not None:
        counts = layout.sum_dp(torch.stack([batch["target_mask"].float().sum(),
                                            batch["end_mask"].float().sum()]))
        if layout.sp is not None:
            start, n = layout.seq_slice(input_embed.shape[1])
            batch = {k: batch[k][:, start:start + n]
                     for k in ("distribute_labels", "target_mask", "end_mask")}
            latents = latents[:, start:start + n]
    return _head_losses(params, cfg, hidden, batch, latents, counts)
