"""Test-time prompt fitting (port of kalle_tpu/infer/optim.py): before
generating, fine-tune the model on the KL of the voice prompt's latents
(the reference's `infer_tools.optim`), resampling the prompt latents each
step, with AdamW under a warmup-cosine schedule, stopping at a loss
threshold.

`prompt_kl_loss` runs the training forward (`llama.forward`): on the card,
with cfg.llama.use_flash_attention, its attention is K5 forward and K6/K7
backward under autograd. Flash takes sequences a multiple of 128 long, so
the text+prompt row is right-padded to one with masked positions; causal
attention keeps the real positions' outputs what they are without the pad.

`prompt_fit` is a host loop (the JAX package runs a `while_loop`):
torch.optim.AdamW with optax's `adamw` defaults (b1 0.9, b2 0.999, eps
1e-8, weight decay on every leaf), the learning rate of update n being
`train.optim.warmup_cosine(n, lr, warmup, train_steps)` (the first update
has lr 0, as optax's count starts at 0); before each step it stops if the
last loss is below the threshold. The noise comes from a
`torch.Generator`, so its numbers are not `jax.random`'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..bridge import tree_leaves, tree_map
from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa
from ..models.lm.losses import gaussian_kl, split_mean_scale_btd
from ..train.optim import warmup_cosine


def prompt_kl_loss(params: dict, cfg: LlasaConfig, input_ids: torch.Tensor,
                   mean: torch.Tensor, logs: torch.Tensor, noise: torch.Tensor
                   ) -> torch.Tensor:
    """KL(predicted || prompt latent distribution) averaged over the
    prompt's frames, the prompt latents mean + exp(logs) * noise.
    input_ids (1, t_text); mean, logs, noise (1, T_a, d)."""
    dt = torch_dtype(cfg.llama.dtype)
    latents = mean + torch.exp(logs) * noise
    text_embed = llama.embed_tokens(params["llama"], input_ids, cfg.llama)
    audio_embed = llasa.audio_proj(params, latents, dt)
    embeds = torch.cat([text_embed, audio_embed], dim=1)
    t = embeds.shape[1]
    pad = -t % 128
    mask = torch.ones(embeds.shape[0], t + pad, dtype=torch.int32, device=embeds.device)
    mask[:, t:] = 0
    hidden = llama.forward(params["llama"], cfg.llama, F.pad(embeds, (0, 0, 0, pad)), mask)
    out = llasa.distribution_head(params, hidden[:, :t], dt)
    t_a = mean.shape[1]
    dis_p = out[:, -1 - t_a:-1, :]
    if cfg.head_variant == "sigma":
        kl = gaussian_kl(dis_p, torch.full_like(dis_p, cfg.sigma),
                         mean, torch.full_like(mean, cfg.sigma))
    else:
        mean2, logs2 = split_mean_scale_btd(dis_p)
        kl = gaussian_kl(mean2, torch.exp(logs2), mean, torch.exp(logs))
    return (kl.sum(2) / mean.shape[-1]).sum() / t_a


def prompt_fit(params: dict, cfg: LlasaConfig, input_ids: torch.Tensor,
               prompt_mean: torch.Tensor, prompt_logs: torch.Tensor,
               generator: torch.Generator, lr: float = 1e-6, weight_decay: float = 1e-2,
               max_steps: int = 200, warmup: int = 60, train_steps: int = 120,
               loss_threshold: Optional[float] = None) -> Tuple[dict, float]:
    """-> (adapted params, the last step's loss). `params` (float leaves;
    f32 masters with cfg.llama.dtype compute, as in training) are copied,
    not changed; the noise is drawn from `generator` (on their device) in
    f32, one (1, T_a, d) draw a step."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda n: warmup_cosine(n, lr, warmup, train_steps) / lr if lr else 0.0)
    loss = float("inf")
    for _ in range(max_steps):
        if loss_threshold is not None and loss < loss_threshold:
            break
        noise = torch.randn(prompt_mean.shape, generator=generator,
                            device=prompt_mean.device, dtype=torch.float32)
        value = prompt_kl_loss(params, cfg, input_ids, prompt_mean, prompt_logs, noise)
        opt.zero_grad(set_to_none=True)
        value.backward()
        opt.step()
        sched.step()
        loss = float(value.detach())
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return params, loss
