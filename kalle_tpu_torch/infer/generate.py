"""KV-cached autoregressive latent generation (port of
kalle_tpu/infer/generate.py).

Prefill runs the left-padded prompts once through the cache; the decode
loop then emits one latent frame per step for every row, with per-row done
flags. The JAX package's `lax.while_loop` becomes a Python loop that stops
once every row is done — reading the flags costs one device-to-host sync a
step. Traced (`utils/trace`): `gen.prefill`, and a `gen.step` each loop
iteration holding its `gen.flag_read` (a loop that stops early ends with a
step that only reads the flags); each step marks the tracer
(`trace.mark`) after its read.

Semantics kept from the JAX package:
  * end of speech: KL(frame dist || N(1, e)) / d < threshold, tested after
    the frame is emitted and only once `min_frames` frames are out. With
    the sigma head (fixed std 0.5) the statistic has an analytic floor of
    about 1.21 > 0.5, so at the default threshold the sigma head never
    stops early; decodes run to max_frames. That is the reference's own
    math, kept as is.
  * the LAST generated frame is discarded: n_frames = steps taken - 1.
  * the sigma head stores the SAMPLED latent; greedy=True emits the mean.

Under a mesh (parallel/mesh.py; params from `shard_params`) each dp rank
decodes its rows of the batch with the layers tensor-parallel over tp
(n_kv/tp KV heads a cache), draws the whole batch's noise and keeps its
rows (the draws of one process), and the results are all-gathered over
dp: every rank returns the single-process result.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa
from ..utils import trace


# decode-loop steps taken in this process, each one forward_with_cache at
# t=1 (a count of K1's launches is held against it: one a layer a step)
decode_steps = 0


class GenResult(NamedTuple):
    means: torch.Tensor        # (b, max_frames, d)
    log_scales: torch.Tensor   # (b, max_frames, d) (log sigma for the sigma head)
    samples: torch.Tensor      # (b, max_frames, d) sampled latents
    n_frames: torch.Tensor     # (b,) valid frame count (last frame discarded)
    end_kl: torch.Tensor       # (b, max_frames) end-detector trace


def _head_step(cfg: LlasaConfig, params, hidden, generator, greedy: bool = False,
               rows: Optional[Tuple[int, int]] = None):
    """hidden (b, 1, h) -> (mean, log_scale, sample) each (b, 1, d). rows =
    (global rows, first row): the noise is drawn for the whole batch and
    these b rows kept."""
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
    total, first = rows or (mean.shape[0], 0)
    noise = torch.randn((total,) + mean.shape[1:], generator=generator, device=mean.device,
                        dtype=mean.dtype)[first:first + mean.shape[0]]
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
    prompt_latents: Optional[torch.Tensor] = None,       # (b, tl, d) audio prompt
    prompt_latents_mask: Optional[torch.Tensor] = None,  # (b, tl) 1 = real frame
    embed_bias: Optional[torch.Tensor] = None,           # (b, h) per-frame conditioning
    greedy: bool = False,
    mesh=None,
) -> GenResult:
    """Batched TTS generation: prompt ids -> latent frames, on the device
    of `input_ids`. `generator` draws the sampling noise (a fresh one seeded
    0 when None). Prompts are left-padded so every row appends frames at
    the same cache slot; RoPE positions are per-row local.

    An audio prompt (`prompt_latents`, e.g. a reference voice's encoder
    means) goes through `audio_proj` after the text, masked by
    `prompt_latents_mask`; a row's positions count its real text tokens and
    prompt frames as one left-padded run, as in the JAX package. The
    `embed_bias` is added to every prefill position (pads too) and to every
    generated frame's input embed."""
    tp, rows, n_kv = None, None, cfg.llama.num_kv_heads
    if mesh is not None:
        from ..parallel.collectives import gather_dim
        from ..parallel.mesh import DP_AXIS, TP_AXIS

        n_dp = mesh.size(DP_AXIS)
        if input_ids.shape[0] % n_dp:
            raise ValueError(f"{input_ids.shape[0]} rows do not split over dp={n_dp}")
        b_loc = input_ids.shape[0] // n_dp
        first = mesh.rank(DP_AXIS) * b_loc
        rows = (input_ids.shape[0], first)
        input_ids, prompt_mask, prompt_latents, prompt_latents_mask, embed_bias = (
            None if a is None else a[first:first + b_loc]
            for a in (input_ids, prompt_mask, prompt_latents, prompt_latents_mask,
                      embed_bias))
        tp = mesh.group(TP_AXIS) if mesh.size(TP_AXIS) > 1 else None
        n_kv //= mesh.size(TP_AXIS)
    out = _generate(params, cfg, input_ids, prompt_mask, generator, max_frames, cache_len,
                    end_kl_threshold, prompt_latents, prompt_latents_mask, embed_bias,
                    greedy, tp, rows, n_kv)
    if mesh is None:
        return out
    return GenResult(*(gather_dim(a, 0, mesh.group(DP_AXIS)) for a in out))


def _generate(params, cfg: LlasaConfig, input_ids, prompt_mask, generator, max_frames,
              cache_len, end_kl_threshold, prompt_latents, prompt_latents_mask, embed_bias,
              greedy, tp_group, rows, n_kv) -> GenResult:
    global decode_steps
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    dev = input_ids.device
    b, tp = input_ids.shape
    thres = cfg.end_kl_threshold if end_kl_threshold is None else end_kl_threshold
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)

    tl = 0 if prompt_latents is None else prompt_latents.shape[1]
    cache_len = cache_len or (tp + tl + max_frames)
    # rounded up to 128 as in the JAX package, whose kernel blocks the cache
    # by 128 (K1 takes any length; the rounding keeps the two caches alike)
    cache_len = -(-cache_len // 128) * 128
    bias = None if embed_bias is None else embed_bias.to(dt)[:, None, :]

    # ---- prefill ----
    with trace.span("gen.prefill"):
        pmask = prompt_mask.bool()
        embeds = llama.embed_tokens(params["llama"], input_ids, lcfg) * pmask[..., None].to(dt)
        if prompt_latents is not None:
            a_embed = llasa.audio_proj(params, prompt_latents, dt)
            if prompt_latents_mask is None:
                lmask = torch.ones((b, tl), dtype=torch.bool, device=dev)
            else:
                lmask = prompt_latents_mask.bool()
                a_embed = a_embed * lmask[..., None].to(dt)
            embeds = torch.cat([embeds, a_embed], dim=1)
            pmask = torch.cat([pmask, lmask], dim=1)
        if bias is not None:
            embeds = embeds + bias
        t_pre = embeds.shape[1]
        # left-padded: local position = slot - n_pads
        n_pads = t_pre - pmask.sum(dim=1)
        positions = (torch.arange(t_pre, device=dev)[None, :] - n_pads[:, None]).clamp_min(0)
        cache = llama.KVCache.zeros(lcfg, b, cache_len, device=dev, n_kv=n_kv)
        valid = torch.zeros((b, cache_len), dtype=torch.bool, device=dev)
        valid[:, :t_pre] = pmask
        hidden, cache = llama.forward_with_cache(params["llama"], lcfg, embeds, cache,
                                                 attention_mask=valid, positions=positions,
                                                 tp=tp_group)
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
        # a step's span: its stop-flag read (the host waits for the card),
        # then the host issuing the step
        with trace.span("gen.step"):
            with trace.span("gen.flag_read"):
                stop = bool(done.all())
            trace.mark(dev)  # the card is idle: a profiler's clock anchors
            if stop:
                break
            mean, lg, sample = _head_step(cfg, params, hidden, generator, greedy, rows)
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
            if bias is not None:
                a_embed = a_embed + bias
            valid[:, cache.length] = live
            hidden, cache = llama.forward_with_cache(
                params["llama"], lcfg, a_embed, cache, attention_mask=valid,
                positions=pos[:, None], tp=tp_group)
            pos = pos + live.long()
            decode_steps += 1

    return GenResult(means=means, log_scales=logs, samples=samples,
                     n_frames=(steps - 1).clamp_min(0), end_kl=endkl)
