"""Llasa: the continuous-latent audio LM, inference subset (port of
kalle_tpu/models/lm/llasa.py:46-79 and 209-214).

A Llama backbone plus `audio_linear` (latent_dim -> audio_proj_dim input
projection) and `distribution_linear` (Linear -> exact GELU -> Linear
head emitting the next frame's latent distribution). Training losses,
`embed_inputs` and the other heads' losses are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.config import LlasaConfig
from . import llama


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
