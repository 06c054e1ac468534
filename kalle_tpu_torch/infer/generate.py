"""KV-cached autoregressive latent generation (port of
kalle_tpu/infer/generate.py:33-200).

Prefill runs the left-padded prompts once through the cache; the decode
loop then emits one latent frame per step for every row, with per-row done
flags. The JAX package's `lax.while_loop` becomes a Python loop that stops
once every row is done — reading the flags costs one device-to-host sync a
step.

Semantics kept from the JAX package:
  * end of speech: KL(frame dist || N(1, e)) / d < threshold, tested after
    the frame is emitted and only once `min_frames` frames are out. With
    the sigma head (fixed std 0.5) the statistic has an analytic floor of
    about 1.21 > 0.5, so at the default threshold the sigma head never
    stops early; decodes run to max_frames. That is the reference's own
    math, kept as is.
  * the LAST generated frame is discarded: n_frames = steps taken - 1.
  * the sigma head stores the SAMPLED latent; greedy=True emits the mean.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa


class GenResult(NamedTuple):
    means: torch.Tensor        # (b, max_frames, d)
    log_scales: torch.Tensor   # (b, max_frames, d) (log sigma for the sigma head)
    samples: torch.Tensor      # (b, max_frames, d) sampled latents
    n_frames: torch.Tensor     # (b,) valid frame count (last frame discarded)
    end_kl: torch.Tensor       # (b, max_frames) end-detector trace


def _head_step(cfg: LlasaConfig, params, hidden, generator, greedy: bool = False):
    """hidden (b, 1, h) -> (mean, log_scale, sample) each (b, 1, d)."""
    out = llasa.distribution_head(params, hidden, hidden.dtype)
    if cfg.head_variant == "sigma":
        mean = out
        logs = torch.full_like(mean, math.log(cfg.sigma))
        std = cfg.sigma
    else:
        d = out.shape[-1] // 2
        mean, logs = out[..., :d], out[..., d:]
        std = torch.exp(logs)
    if greedy:
        return mean, logs, mean
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean, logs, mean + std * noise


@torch.no_grad()
def generate(
    params: dict,
    cfg: LlasaConfig,
    input_ids: torch.Tensor,      # (b, tp) LEFT-padded prompt ids
    prompt_mask: torch.Tensor,    # (b, tp) 1 = real token
    generator: Optional[torch.Generator] = None,
    max_frames: int = 200,
    cache_len: int = 0,
    end_kl_threshold: Optional[float] = None,
    greedy: bool = False,
) -> GenResult:
    """Batched TTS generation: prompt ids -> latent frames, on the device
    of `input_ids`. `generator` draws the sampling noise (a fresh one seeded
    0 when None). Prompts are left-padded so every row appends frames at
    the same cache slot; RoPE positions are per-row local."""
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    dev = input_ids.device
    b, tp = input_ids.shape
    thres = cfg.end_kl_threshold if end_kl_threshold is None else end_kl_threshold
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)

    cache_len = cache_len or (tp + max_frames)
    # rounded up to 128 as in the JAX package, whose kernel blocks the cache
    # by 128 (K1 takes any length; the rounding keeps the two caches alike)
    cache_len = -(-cache_len // 128) * 128

    # ---- prefill ----
    pmask = prompt_mask.bool()
    embeds = llama.embed_tokens(params["llama"], input_ids, lcfg) * pmask[..., None].to(dt)
    n_pads = tp - pmask.sum(dim=1)  # left-padded: local position = slot - n_pads
    positions = (torch.arange(tp, device=dev)[None, :] - n_pads[:, None]).clamp_min(0)
    cache = llama.KVCache.zeros(lcfg, b, cache_len, device=dev)
    valid = torch.zeros((b, cache_len), dtype=torch.bool, device=dev)
    valid[:, :tp] = pmask
    hidden, cache = llama.forward_with_cache(params["llama"], lcfg, embeds, cache,
                                             attention_mask=valid, positions=positions)
    hidden = hidden[:, -1:, :]

    d = cfg.latent_dim
    means = torch.zeros((b, max_frames, d), dtype=dt, device=dev)
    logs = torch.zeros_like(means)
    samples = torch.zeros_like(means)
    endkl = torch.zeros((b, max_frames), dtype=torch.float32, device=dev)
    pos = positions[:, -1] + 1  # next local position per row
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int32, device=dev)

    for i in range(max_frames):
        if bool(done.all()):
            break
        mean, lg, sample = _head_step(cfg, params, hidden, generator, greedy)
        kl = llasa.end_kl(cfg, mean, torch.exp(lg.float()))[:, 0]
        live = ~done
        keep = live[:, None]
        means[:, i] = torch.where(keep, mean[:, 0], 0).to(dt)
        logs[:, i] = torch.where(keep, lg[:, 0], 0).to(dt)
        samples[:, i] = torch.where(keep, sample[:, 0], 0).to(dt)
        endkl[:, i] = torch.where(live, kl, 0.0)
        steps += live.int()

        # stop test AFTER emitting; the gate opens once min_frames are out
        done = done | ((kl < thres) & (i >= cfg.min_frames))

        a_embed = llasa.audio_proj(params, sample, dt)
        valid[:, cache.length] = live
        hidden, cache = llama.forward_with_cache(
            params["llama"], lcfg, a_embed, cache, attention_mask=valid,
            positions=pos[:, None])
        pos = pos + live.long()

    return GenResult(means=means, log_scales=logs, samples=samples,
                     n_frames=(steps - 1).clamp_min(0), end_kl=endkl)
