"""Streaming (text/audio interleave) generation with a KV cache (port of
kalle_tpu/infer/streaming.py).

The audio stream runs `delay` frames behind the text: a sampled speaker
frame, then t_warm warm-up steps of text_embed[i] + audio_embed(warm-up
latent) fill the cache in one prefill; each later step consumes
text_embed[min(t_warm + 1 + i, t_text - 1)] + audio_embed(the last
sample) and stops on the end-KL test. The head is the variants' Linear
distribution_linear (mean||log_scale). The JAX `lax.while_loop` becomes a
host loop that reads the done flags once a step; every t=1 step runs K1
in every layer (and K2/K3 with int8 layer weights).

The step's N(0, 1) draw ((b, 1, d)) comes from `generator`, or from
`noise` (b, max_steps, d): step i takes noise[:, i].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa
from ..models.lm.losses import split_mean_scale_btd


class StreamResult(NamedTuple):
    means: torch.Tensor       # (b, max_steps, d)
    log_scales: torch.Tensor
    samples: torch.Tensor
    n_frames: torch.Tensor    # (b,) steps taken - 1


def _lin(params, name, x, dt):
    p = params[name]
    return x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


@torch.no_grad()
def stream_generate(
    params: dict,
    cfg: LlasaConfig,
    input_ids: torch.Tensor,       # (b, t_text), pad-token padded
    prompt_latents: torch.Tensor,  # (b, t_warm, d) delay warm-up latents
    speaker_cond: torch.Tensor,    # (b, h) sampled speaker frame
    generator: Optional[torch.Generator] = None,
    max_steps: int = 200,
    end_kl_threshold: Optional[float] = None,
    noise: Optional[torch.Tensor] = None,
) -> StreamResult:
    """Streaming decode on the device of `input_ids`; `generator` defaults
    to one seeded 0."""
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    dev = input_ids.device
    b, t_text = input_ids.shape
    t_warm = prompt_latents.shape[1]
    thres = cfg.end_kl_threshold if end_kl_threshold is None else end_kl_threshold
    if noise is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    text_embed = llama.embed_tokens(params["llama"], input_ids, lcfg)
    prefix = text_embed[:, :t_warm] + _lin(params, "audio_linear", prompt_latents, dt)
    prefix = torch.cat([speaker_cond.to(dt)[:, None, :], prefix], dim=1)
    cache_len = -(-(1 + t_text + max_steps + 1) // 128) * 128
    cache = llama.KVCache.zeros(lcfg, b, cache_len, device=dev)
    hidden, cache = llama.forward_with_cache(params["llama"], lcfg, prefix, cache)
    hidden = hidden[:, -1:]

    d = cfg.latent_dim
    means = torch.zeros((b, max_steps, d), dtype=dt, device=dev)
    logs = torch.zeros_like(means)
    samples = torch.zeros_like(means)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int32, device=dev)

    for i in range(max_steps):
        if bool(done.all()):
            break
        mean, lg = split_mean_scale_btd(_lin(params, "distribution_linear", hidden, dt))
        eps = (torch.randn(mean.shape, generator=generator, device=dev, dtype=dt)
               if noise is None else noise[:, i:i + 1].to(dev, dt))
        sample = mean + torch.exp(lg) * eps

        live = ~done
        keep = live[:, None]
        means[:, i] = torch.where(keep, mean[:, 0], 0).to(dt)
        logs[:, i] = torch.where(keep, lg[:, 0], 0).to(dt)
        samples[:, i] = torch.where(keep, sample[:, 0], 0).to(dt)
        steps += live.int()
        kl = llasa.end_kl(cfg, mean, torch.exp(lg.float()))[:, 0]
        done = done | ((kl < thres) & (i >= cfg.min_frames))

        j = min(t_warm + 1 + i, t_text - 1)
        nxt = text_embed[:, j:j + 1] + _lin(params, "audio_linear", sample, dt)
        hidden, cache = llama.forward_with_cache(params["llama"], lcfg, nxt, cache)

    return StreamResult(means=means, log_scales=logs, samples=samples,
                        n_frames=(steps - 1).clamp_min(0))


def warmup_latents_from_silence(codec_encode_fn, delay_frames: int, sample_rate: int,
                                frame_hz: float, batch: int = 1, device="cuda"):
    """The zero-audio delay warm-up: delay_frames * (sample_rate /
    frame_hz) silent samples (batch, 1, n) through `codec_encode_fn`."""
    n = int(round(delay_frames * sample_rate / frame_hz))
    return codec_encode_fn(torch.zeros((batch, 1, n), device=device))


def sample_speaker_cond(params: dict, generator: Optional[torch.Generator], h: int,
                        spk_embedding: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None, device="cuda") -> torch.Tensor:
    """The speaker VAE's frame at inference. With a speaker embedding (b,
    h): N(0, 1) * exp(logs) of its speaker_cond_disp_linear — the
    reference omits the mean here, and so does this port. Without one:
    N(0, 1) of shape (1, h) on `device`. `noise` injects the draw."""
    if spk_embedding is None:
        shape, dev, logs = (1, h), device, None
    else:
        pd = params["speaker_cond_disp_linear"]
        logs = (spk_embedding @ pd["w"] + pd["b"])[..., h:]
        shape, dev = logs.shape, logs.device
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} for a draw of {tuple(shape)}")
        eps = noise.to(dev, torch.float32)
    else:
        eps = torch.randn(shape, generator=generator, device=dev)
    return eps if logs is None else eps * torch.exp(logs)
