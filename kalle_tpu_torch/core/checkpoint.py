"""Training checkpoints (port of kalle_tpu/core/checkpoint.py's
CheckpointManager, with torch.save in place of orbax), and the reference
checkpoint import.

A checkpoint holds the step, the params, the AdamW state (moments and
per-parameter step counts) and the schedule's state, so a resumed run
continues the uninterrupted one exactly. One file a step,
`<dir>/step_<N>.pt`, written to a temporary name and renamed; the newest
`max_to_keep` are kept.

Saving is asynchronous, as orbax's is: `save` copies the state to host
memory on the caller's thread (so training may go on changing it), then
one background thread writes the file and prunes old ones. `save(...,
wait=True)`, the next `save`, `restore`, `steps` and `close` wait for
that thread, and raise what it raised. A step at or below the newest
saved one is not saved again (orbax's `should_save`).

Also the flat .npz export of a param tree, `load_reference_llasa_checkpoint`
(a reference `epoch_E_step_S.pt` or `.safetensors` state dict through
`models/lm/convert.py`) and the inference entry points' loader
`load_llasa_params`.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_jax, params_to_numpy, tree_leaves, tree_map

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(tree: Any) -> Any:
    """A copy of every tensor leaf of a nested dict/list tree in host
    memory (other leaves as they are)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_saved: Optional[int] = None
        self.write_s = 0.0  # seconds the writer thread spent writing and pruning

    def _join(self) -> None:
        """Wait for the writer thread; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            self._last_saved = None  # read from the directory again
            raise err

    def steps(self) -> list:
        self._join()
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _write(self, step: int, payload: dict) -> None:
        t0 = time.perf_counter()
        try:
            tmp = self._path(step) + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
            saved = sorted(int(m.group(1)) for m in map(_NAME.match,
                                                        os.listdir(self.directory)) if m)
            for old in saved[:-self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # noqa: BLE001 — raised on the caller's next join
            self._error = e
        self.write_s += time.perf_counter() - t0

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Save `state` (anything with `state_dict` / `load_state_dict`: a
        train.step.TrainState or a train.codec_trainer.CodecTrainState) as
        step `step`: copied to host memory here, written on the writer
        thread. wait=True returns once the file is written."""
        self._join()
        if self._last_saved is None:
            self._last_saved = self.latest_step()
        if self._last_saved is None or step > self._last_saved:
            payload = _to_host(state.state_dict())
            self._last_saved = step
            self._writer = threading.Thread(target=self._write, args=(step, payload),
                                            name=f"checkpoint-{step}", daemon=True)
            self._writer.start()
            if wait:
                self._join()

    def close(self) -> None:
        """Wait for the pending save; the manager stays usable."""
        self._join()

    def restore(self, state_template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Load checkpoint `step` (default: the newest) into
        `state_template` in place (its `load_state_dict`). -> (state,
        step); (template, 0) when there is none."""
        payload, step = self.load(step)
        if payload is None:
            return state_template, 0
        state_template.load_state_dict(payload)
        return state_template, step

    def load(self, step: Optional[int] = None) -> Tuple[Optional[dict], int]:
        """The saved state dict of checkpoint `step` (default: the newest)
        on the host, and its step; (None, 0) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, 0
        # onto the host: `restore` copies params to their device, and the
        # optimizer moves its moments to theirs and keeps its step counts on
        # the host, where AdamW wants them
        return torch.load(self._path(step), map_location="cpu", weights_only=True), step


def copy_leaves_(dst_tree: Any, src_tree: Any, what: str) -> None:
    """Copy every tensor leaf of `src_tree` into the same leaf of
    `dst_tree` (a checkpoint into live params), shapes checked."""
    dst, src = tree_leaves(dst_tree), tree_leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} leaves for {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f"{what}: a leaf of shape {tuple(s.shape)} for one of "
                                 f"{tuple(d.shape)}")
            d.copy_(s)


def load_reference_llasa_checkpoint(path: str, cfg, device="cuda") -> dict:
    """Warm start from a reference `epoch_E_step_S.pt` (or `.safetensors`)
    Llasa state dict: the port's f32 param tree on `device`."""
    from ..models.lm.convert import llasa_params_from_state_dict, load_torch_checkpoint

    return params_from_jax(llasa_params_from_state_dict(load_torch_checkpoint(path), cfg),
                           device=device)


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
    a reference `.pt` / `.safetensors` state dict (f32), or, for an empty
    `path`, a random f32 init seeded `seed`."""
    if not path:
        from ..models.lm import llasa

        print("WARNING: no checkpoint given — random init (smoke mode)")
        return llasa.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    if path.endswith(".npz"):
        return params_from_jax(load_params_npz(path), device=device)
    if path.endswith((".pt", ".safetensors")):
        return load_reference_llasa_checkpoint(path, cfg, device)
    raise ValueError(f"{path}: expected a .npz params file or a reference .pt / "
                     ".safetensors checkpoint")
