"""Classifier-free-guidance decoding (port of kalle_tpu/infer/cfg.py).

Two KV caches, one for the conditional branch and one for the CFG branch
(v1: the text masked out of the prompt, generated frames visible; v2: the
prompt kept, generated frames masked — each decode row then attends over
the prompt without its own new key). Each step samples the guided latent
from the weighted difference of the two branches' distributions
(K = guidance_k) and feeds it to both. The JAX `lax.while_loop` becomes a
host loop, as in `generate`, that reads the done flags once a step.

Every t=1 step of both branches runs K1 in every layer, and K2/K3 with
int8 layer weights (models/lm/llama.py). The prefills attend through the
plain masked path over the whole zero-filled cache: under the finite
NEG_INF, v1's CFG prefill (every prompt key masked) averages every cache
slot uniformly, unwritten ones included, as the JAX package does.

The step's N(0, 1) draw ((b, 1, d)) comes from `generator`, or from
`noise` (b, max_frames, d): frame i takes noise[:, i].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa
from ..models.lm.losses import split_mean_scale_btd
from ..models.lm.variants import batch_weighted_difference_sampling


class CFGResult(NamedTuple):
    means: torch.Tensor        # (b, max_frames, d)
    log_scales: torch.Tensor
    samples: torch.Tensor
    n_frames: torch.Tensor     # (b,) steps taken - 1


def _lin(params, name, x, dt):
    """`name`'s projection of x: the MLP distribution head when its params
    hold "w0", else a Linear."""
    p = params[name]
    if name == "distribution_linear" and "w0" in p:
        return llasa.distribution_head(params, x.to(dt), dt)
    return x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


@torch.no_grad()
def cfg_generate(
    params: dict,
    cfg: LlasaConfig,
    input_ids: torch.Tensor,   # (b, t_text); the reference runs b = 1
    generator: Optional[torch.Generator] = None,
    max_frames: int = 200,
    cfg_variant: str = "v1",
    guidance_k: float = 0.1,
    cfg_prob: float = 0.5,
    end_kl_threshold: Optional[float] = None,
    noise: Optional[torch.Tensor] = None,
) -> CFGResult:
    """Guided generation on the device of `input_ids`. cfg_prob is kept for
    the JAX signature (neither branch drops audio frames here: the prompt
    holds text only). `generator` defaults to one seeded 0."""
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    dev = input_ids.device
    b, t_text = input_ids.shape
    thres = cfg.end_kl_threshold if end_kl_threshold is None else end_kl_threshold
    if cfg_variant not in ("v1", "v2"):
        raise ValueError(cfg_variant)
    if noise is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    append_live = cfg_variant == "v1"  # v1: generated frames stay visible in the CFG branch

    embeds = llama.embed_tokens(params["llama"], input_ids, lcfg)
    cache_len = -(-(t_text + max_frames + 1) // 128) * 128

    def prefill(prompt_visible: bool):
        cache = llama.KVCache.zeros(lcfg, b, cache_len, device=dev)
        valid = torch.zeros((b, cache_len), dtype=torch.bool, device=dev)
        valid[:, :t_text] = prompt_visible
        h, cache = llama.forward_with_cache(params["llama"], lcfg, embeds, cache,
                                            attention_mask=valid)
        return h[:, -1:], cache, valid

    hid_c, cache_c, valid_c = prefill(True)
    hid_u, cache_u, valid_u = prefill(cfg_variant == "v2")

    d = cfg.latent_dim
    means = torch.zeros((b, max_frames, d), dtype=dt, device=dev)
    logs = torch.zeros_like(means)
    samples = torch.zeros_like(means)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int32, device=dev)

    for i in range(max_frames):
        if bool(done.all()):
            break
        mean, lg = split_mean_scale_btd(_lin(params, "distribution_linear", hid_c, dt))
        mean_u, lg_u = split_mean_scale_btd(_lin(params, "distribution_linear", hid_u, dt))
        sample = batch_weighted_difference_sampling(
            generator, mean, torch.exp(lg), mean_u, torch.exp(lg_u), K=guidance_k,
            noise=None if noise is None else noise[:, i:i + 1])

        live = ~done
        keep = live[:, None]
        means[:, i] = torch.where(keep, mean[:, 0], 0).to(dt)
        logs[:, i] = torch.where(keep, lg[:, 0], 0).to(dt)
        samples[:, i] = torch.where(keep, sample[:, 0], 0).to(dt)
        steps += live.int()
        kl = llasa.end_kl(cfg, mean, torch.exp(lg.float()))[:, 0]
        done = done | ((kl < thres) & (i >= cfg.min_frames))

        a_embed = _lin(params, "audio_linear", sample, dt)
        slot = cache_c.length
        valid_c[:, slot] = live
        valid_u[:, slot] = live if append_live else False
        hid_c, cache_c = llama.forward_with_cache(params["llama"], lcfg, a_embed, cache_c,
                                                  attention_mask=valid_c)
        hid_u, cache_u = llama.forward_with_cache(params["llama"], lcfg, a_embed, cache_u,
                                                  attention_mask=valid_u)

    return CFGResult(means=means, log_scales=logs, samples=samples,
                     n_frames=(steps - 1).clamp_min(0))
