"""Training checkpoints (port of kalle_tpu/core/checkpoint.py's
CheckpointManager, with torch.save in place of orbax).

A checkpoint holds the step, the params, the AdamW state (moments and
per-parameter step counts) and the schedule's state, so a resumed run
continues the uninterrupted one exactly. One file a step,
`<dir>/step_<N>.pt`, written to a temporary name and renamed; the newest
five are kept. Also the flat .npz export of a param tree, and the
inference entry points' Llasa loader (`load_llasa_params`).
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_jax, params_to_numpy, tree_leaves, tree_map

_NAME = re.compile(r"^step_(\d+)\.pt$")
MAX_TO_KEEP = 5


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write `state` (a train.step.TrainState) as step `step`. Saving is
        synchronous: `wait` is accepted for the JAX package's signature."""
        payload = {"step": int(state.step),
                   "params": tree_map(lambda t: t.detach().cpu(), state.params),
                   "optimizer": state.optimizer.state_dict(),
                   "scheduler": state.scheduler.state_dict()}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))

    def restore(self, state_template: Any) -> Tuple[Any, int]:
        """Load the newest checkpoint into `state_template` in place: params
        copied into its tensors, optimizer and schedule state loaded.
        -> (state, step); (template, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state_template, 0
        # onto the host: params are copied to their device below, and the
        # optimizer moves its moments to theirs and keeps its step counts on
        # the host, where AdamW wants them
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state_template.params),
                                tree_leaves(payload["params"])):
                if dst.shape != src.shape:
                    raise ValueError(f"checkpoint step {step}: a param of shape "
                                     f"{tuple(src.shape)} for one of {tuple(dst.shape)}")
                dst.copy_(src)
        state_template.optimizer.load_state_dict(payload["optimizer"])
        state_template.scheduler.load_state_dict(payload["scheduler"])
        state_template.step = int(payload["step"])
        return state_template, step


def save_params_npz(path: str, params: dict) -> None:
    """Flat .npz export, keys joined with '/'."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = tree

    walk("", params_to_numpy(params))
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """The nested numpy tree of a `save_params_npz` file."""
    data = np.load(path)
    tree: dict = {}
    for k in data.files:
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[k]
    return tree


def load_llasa_params(path: str, cfg, device="cuda", seed: int = 0) -> dict:
    """The Llasa params of the inference entry points, on `device`: a
    `save_params_npz` file (its leaves as saved: int8 weights stay int8),
    or, for an empty `path`, a random f32 init seeded `seed`. A reference
    `.pt` checkpoint needs the HF/Llasa state-dict converter, which is not
    ported yet (ROADMAP.md, A9)."""
    if not path:
        from ..models.lm import llasa

        print("WARNING: no checkpoint given — random init (smoke mode)")
        return llasa.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    if path.endswith(".npz"):
        return params_from_jax(load_params_npz(path), device=device)
    if path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: reference .pt Llasa checkpoints need models/lm/convert.py, which "
            "is not ported yet (ROADMAP.md, A9); pass a .npz from save_params_npz")
    raise ValueError(f"{path}: expected a .npz params file (or a .pt, not ported yet)")
