"""The training step (port of kalle_tpu/train/step.py:33-181, without the
1F1B pipeline loss).

forward -> total = audio_loss * w_a + end_loss * w_e -> backward ->
optional global-norm clip -> one AdamW update -> the schedule advances.
With gradient_accumulation_steps A > 1 the batch leaves carry a leading
microbatch axis (A, B, ...): each microbatch's loss is scaled by 1/A before
its backward and the gradients sum in the f32 `.grad` buffers, so only one
microbatch's activations are live at a time and one update follows.

Randomness (the sigma head's input noise) comes from a `torch.Generator`
seeded from (seed, step, microbatch), so a resumed run replays the same
draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..bridge import tree_leaves
from ..core.config import LlasaConfig, TrainConfig
from ..models.lm import llasa
from .optim import clip_by_global_norm_, global_norm, make_optimizer


@dataclass
class TrainState:
    params: dict  # f32 master tree; every leaf requires grad
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def state_dict(self) -> dict:
        """What a checkpoint holds (core/checkpoint.CheckpointManager)."""
        return {"step": self.step, "params": self.params,
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy a `state_dict` into this state's tensors and optimizer."""
        from ..core.checkpoint import copy_leaves_

        copy_leaves_(self.params, sd["params"], f"checkpoint step {sd['step']} params")
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


def make_train_state(params: dict, tcfg: TrainConfig) -> TrainState:
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = make_optimizer(tcfg, leaves)
    return TrainState(params=params, optimizer=opt, scheduler=sched, step=0)


def step_generator(seed: int, step: int, micro: int, device) -> torch.Generator:
    """The generator of microbatch `micro` of update `step`."""
    mixed = ((seed * 1_000_003 + step) * 1_009 + micro) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def loss_fn(params: dict, cfg: LlasaConfig, tcfg: TrainConfig,
            batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
            latent_noise: Optional[torch.Tensor] = None, use_flash: Optional[bool] = None):
    out = llasa.forward(params, cfg, batch, generator=generator,
                        latent_noise=latent_noise, use_flash=use_flash)
    total = (out["audio_loss"] * tcfg.audio_loss_weight
             + out["end_loss"] * tcfg.end_loss_weight)
    return total, {"total_loss": total, "audio_loss": out["audio_loss"],
                   "end_loss": out["end_loss"]}


def train_step(state: TrainState, cfg: LlasaConfig, tcfg: TrainConfig,
               batch: Dict[str, torch.Tensor], seed: int = 0,
               use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """One optimizer update, in place on `state`; returns the step's
    metrics as detached 0-d tensors (means over the microbatches)."""
    leaves: List[torch.Tensor] = tree_leaves(state.params)
    state.optimizer.zero_grad(set_to_none=True)
    accum = tcfg.gradient_accumulation_steps
    micro = [{k: v[i] for k, v in batch.items()} for i in range(accum)] if accum > 1 \
        else [batch]
    dev = leaves[0].device
    per_micro = []
    for i, mb in enumerate(micro):
        gen = step_generator(seed, state.step, i, dev)
        loss, m = loss_fn(state.params, cfg, tcfg, mb, generator=gen, use_flash=use_flash)
        (loss / accum if accum > 1 else loss).backward()
        per_micro.append({k: v.detach() for k, v in m.items()})
    metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
    grads = []
    for p in leaves:  # a parameter the loss does not reach gets a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if tcfg.log_grad_norm or tcfg.max_grad_norm:
        norm = global_norm(grads)
        if tcfg.log_grad_norm:
            metrics["grad_norm"] = norm
        if tcfg.max_grad_norm:
            clip_by_global_norm_(grads, tcfg.max_grad_norm, norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics
