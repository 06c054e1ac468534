"""The training step (port of kalle_tpu/train/step.py:33-181).

forward -> total = audio_loss * w_a + end_loss * w_e -> backward ->
optional global-norm clip -> one AdamW update -> the schedule advances.
With gradient_accumulation_steps A > 1 the batch leaves carry a leading
microbatch axis (A, B, ...): each microbatch's loss is scaled by 1/A before
its backward and the gradients sum in the f32 `.grad` buffers, so only one
microbatch's activations are live at a time and one update follows.

Randomness (the sigma head's input noise) comes from a `torch.Generator`
seeded from (seed, step, microbatch), so a resumed run replays the same
draws.

Under a parallel layout (`TrainState.layout`, parallel/mesh.py) every rank
steps its shards with its dp rows of the batch:
  * the losses divide by the global batch's mask counts (summed over dp),
    so the ranks' losses are shares that sum to the single-process loss,
    and so do their gradients; the metrics are those sums;
  * each rank draws the global batch's noise and keeps its rows, the
    draws one process makes for them;
  * gradients are summed over dp and sp in flat buckets (fsdp's layer
    shards get theirs from the gathers' reduce-scatter);
  * the global norm reduces each leaf's square sum over the axes it is
    sharded on;
  * with pp > 1 and LlamaConfig.pp_schedule "1f1b", the loss runs through
    the 1F1B schedule (`_loss_1f1b`), else GPipe inside llama.forward.
A checkpoint (`state_dict`) holds the gathered full tensors, so a run
saved at one layout restores at another.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..bridge import tree_leaves
from ..core.config import LlasaConfig, TrainConfig, torch_dtype
from ..models.lm import llama, llasa
from ..parallel.mesh import PP_AXIS, shard_leaf, spec_leaves
from .optim import clip_by_global_norm_, global_norm, make_optimizer


@dataclass
class TrainState:
    params: dict  # f32 master tree (this rank's shards); every leaf requires grad
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    layout: Any = None  # parallel.mesh.Layout, or None on one process

    def _moments(self, sd: dict, fn) -> dict:
        """The optimizer state dict with fn(tensor, spec) applied to every
        per-parameter tensor of a parameter's shape (AdamW's moments)."""
        specs = spec_leaves(self.layout.specs)
        state = {i: {k: (fn(v, specs[i]) if torch.is_tensor(v) and v.dim() else v)
                     for k, v in st.items()} for i, st in sd["state"].items()}
        return {**sd, "state": state}

    def state_dict(self) -> dict:
        """What a checkpoint holds (core/checkpoint.CheckpointManager): full
        tensors; under a layout every rank gathers them (a collective)."""
        params, opt = self.params, self.optimizer.state_dict()
        if self.layout is not None:
            params = self.layout.gather(params)
            opt = self._moments(opt, self.layout.gather_leaf)
        return {"step": self.step, "params": params, "optimizer": opt,
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy a `state_dict` (full tensors) into this state's tensors (its
        shards under a layout) and optimizer."""
        from ..core.checkpoint import copy_leaves_

        params, opt = sd["params"], sd["optimizer"]
        if self.layout is not None:
            mesh = self.layout.mesh
            params = self.layout.shard(params)
            opt = self._moments(opt, lambda v, spec: shard_leaf(v, spec, mesh.shape,
                                                                mesh.coords()))
        copy_leaves_(self.params, params, f"checkpoint step {sd['step']} params")
        self.optimizer.load_state_dict(opt)
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


def make_train_state(params: dict, tcfg: TrainConfig, layout=None) -> TrainState:
    """params: the full tree, or this rank's shards under `layout`."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = make_optimizer(tcfg, leaves)
    return TrainState(params=params, optimizer=opt, scheduler=sched, step=0, layout=layout)


def step_generator(seed: int, step: int, micro: int, device) -> torch.Generator:
    """The generator of microbatch `micro` of update `step`."""
    mixed = ((seed * 1_000_003 + step) * 1_009 + micro) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def loss_fn(params: dict, cfg: LlasaConfig, tcfg: TrainConfig,
            batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
            latent_noise: Optional[torch.Tensor] = None, use_flash: Optional[bool] = None,
            layout=None):
    if layout is not None and layout.mesh.size(PP_AXIS) > 1 \
            and cfg.llama.pp_schedule == "1f1b":
        return _loss_1f1b(params, cfg, tcfg, batch, generator, latent_noise, use_flash,
                          layout)
    out = llasa.forward(params, cfg, batch, generator=generator,
                        latent_noise=latent_noise, use_flash=use_flash, layout=layout)
    total = (out["audio_loss"] * tcfg.audio_loss_weight
             + out["end_loss"] * tcfg.end_loss_weight)
    return total, {"total_loss": total, "audio_loss": out["audio_loss"],
                   "end_loss": out["end_loss"]}


def _loss_1f1b(params: dict, cfg: LlasaConfig, tcfg: TrainConfig,
               batch: Dict[str, torch.Tensor], generator, latent_noise, use_flash, layout,
               stats: Optional[dict] = None):
    """The loss through the 1F1B schedule (parallel/pipeline_1f1b.py; JAX
    step.py:56-124): the embedding outside, the stage's layers inside,
    the final norm, head and losses on the last stage, with the global
    mask counts folded into each microbatch's share."""
    from ..parallel.pipeline_1f1b import pipeline_1f1b_loss

    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    x, am, _ = llasa.embed_inputs(params, cfg, batch, generator, latent_noise)
    t = x.shape[1]
    if use_flash is None:
        use_flash = lcfg.use_flash_attention and x.is_cuda
    flash_pad = am if use_flash and t % 128 == 0 else None
    mask = None if flash_pad is not None else llama.make_causal_padding_mask(am, t)
    n_mb = lcfg.pp_microbatches
    mb = x.shape[0] // n_mb
    stage = llama.pipeline_stage(lcfg, x, mask, flash_pad, layout.tp, n_mb)
    tm, em = batch["target_mask"].float(), batch["end_mask"].float()
    c_a, c_e = layout.sum_dp(torch.stack([tm.sum(), em.sum()])).clamp_min(1.0)
    labels = batch["distribute_labels"]
    w_a, w_e = tcfg.audio_loss_weight, tcfg.end_loss_weight

    def head_loss(hp, y, m):
        rows = slice(m * mb, (m + 1) * mb)
        hidden = llama.rms_norm(y, hp["final_norm"].to(dt), lcfg.rms_norm_eps)
        kl_elem, _, _ = llasa.head_kl(hp, cfg, hidden, labels[rows])
        kl = kl_elem.sum(dim=2) / float(cfg.latent_dim)
        s_a = (kl * tm[rows]).sum() / c_a
        s_e = (kl * em[rows]).sum() / c_e
        return w_a * s_a + w_e * s_e, {"audio_loss": s_a, "end_loss": s_e}

    head = {"final_norm": params["llama"]["final_norm"],
            "distribution_linear": params["distribution_linear"]}
    total, aux = pipeline_1f1b_loss(stage, head_loss, ("audio_loss", "end_loss"),
                                    params["llama"]["layers"], head, x, n_mb,
                                    layout.mesh.group(PP_AXIS), stats)
    return total, {"total_loss": total, **aux}


def train_step(state: TrainState, cfg: LlasaConfig, tcfg: TrainConfig,
               batch: Dict[str, torch.Tensor], seed: int = 0,
               use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """One optimizer update, in place on `state`; returns the step's
    metrics as detached 0-d tensors (means over the microbatches; under a
    layout, of the global batch)."""
    leaves: List[torch.Tensor] = tree_leaves(state.params)
    layout = state.layout
    state.optimizer.zero_grad(set_to_none=True)
    accum = tcfg.gradient_accumulation_steps
    micro = [{k: v[i] for k, v in batch.items()} for i in range(accum)] if accum > 1 \
        else [batch]
    dev = leaves[0].device
    per_micro = []
    for i, mb in enumerate(micro):
        gen = step_generator(seed, state.step, i, dev)
        noise = None
        if layout is not None and cfg.head_variant == "sigma":
            noise = layout.global_noise(gen, mb["audio_latents"].shape, dev)
        loss, m = loss_fn(state.params, cfg, tcfg, mb, generator=gen, latent_noise=noise,
                          use_flash=use_flash, layout=layout)
        (loss / accum if accum > 1 else loss).backward()
        per_micro.append({k: v.detach() for k, v in m.items()})
    metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
    grads = []
    for p in leaves:  # a parameter the loss does not reach gets a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    norm_fn = global_norm
    if layout is not None:
        metrics = dict(zip(metrics, layout.sum_data(torch.stack(list(metrics.values())))))
        layout.sync_grads(state.params)
        norm_fn = layout.global_norm
    if tcfg.log_grad_norm or tcfg.max_grad_norm:
        norm = norm_fn(grads)
        if tcfg.log_grad_norm:
            metrics["grad_norm"] = norm
        if tcfg.max_grad_norm:
            clip_by_global_norm_(grads, tcfg.max_grad_norm, norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics
