"""Optimizer and LR schedule (port of kalle_tpu/train/optim.py).

AdamW(b1 0.9, b2 0.999, eps 1e-8, weight decay on every parameter) with
optax's `warmup_cosine_decay_schedule(0, lr, warmup, decay_steps=total)`,
evaluated at the count of updates made so far (the first update uses
lr 0), and optax's `clip_by_global_norm`.

`torch.optim.AdamW` makes the same update as optax's `adamw`:
p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), the decay taken on the
parameter before the update. The schedule is a plain function behind a
`LambdaLR` stepped once an update.

Also optax's `cosine_decay_schedule` and `adam` over it, which the codec
demo, the CTC ASR and the speaker embedder train with.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

from ..core.config import TrainConfig


def warmup_cosine(step: int, peak: float, warmup_steps: int, total_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total, end 0)."""
    warmup = max(warmup_steps, 1)
    if step < warmup:
        return peak * step / warmup
    decay = max(total_steps, 2) - warmup
    count = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay))


def cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * 0.5 * (1 +
    cos(pi * min(n, T) / T)) + alpha)."""
    def schedule(n: int) -> float:
        c = min(n, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
                       + alpha)

    return schedule


def adam_cosine(leaves, lr: float, steps: int, alpha: float):
    """optax.adam(cosine_decay_schedule(lr, steps, alpha)): torch Adam (b1
    0.9, b2 0.999, eps 1e-8, no weight decay) behind a LambdaLR; the
    schedule is evaluated at the count of updates made so far."""
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = cosine_decay(lr, steps, alpha)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, (lambda n: sched(n) / lr) if lr else (lambda n: 0.0))


def lr_at(cfg: TrainConfig, step: int) -> float:
    """The learning rate of update number `step` (0-based)."""
    if cfg.scheduler != "cosine":
        return cfg.lr
    return warmup_cosine(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]):
    """-> (AdamW, LambdaLR). The scheduler multiplies lr by
    lr_at(step) / lr; with lr 0 every update is 0 anyway."""
    opt = torch.optim.AdamW(list(params), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    scale = (lambda step: lr_at(cfg, step) / cfg.lr) if cfg.lr else (lambda step: 0.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, scale)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, in f32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g * max_norm / ||g|| when
    ||g|| >= max_norm, else g unchanged (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_)."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
