"""Parameter bridge: a JAX param tree, already converted to numpy, -> torch.

The port keeps the JAX package's parameter layouts at rest, so a tree moves
across leaf by leaf with its structure unchanged:

  * Llama layers stay stacked on a leading L axis (`layers/wq` is
    (L, in, out), kalle_tpu/models/lm/llama.py:134-158);
  * int8 weights stay `{'q': int8 (L, in, out), 'scale': f32 (L, out)}`
    dicts (kalle_tpu/ops/quant.py:74-106);
  * the Llasa heads keep `audio_linear/{w,b}` and
    `distribution_linear/{w0,b0,w2,b2}` with (in, out) weights
    (kalle_tpu/models/lm/llasa.py:46-66);
  * SigmaVAE convs stay NWC kernels (K, Cin/groups, Cout)
    (kalle_tpu/models/codecs/sigmavae.py:90-142); `ops/conv.py` takes them
    in that layout.

Only numpy goes in: a caller holding JAX arrays maps `np.asarray` over its
tree first, so this module never needs JAX. An f32 training tree crosses
as f32 (`dtype=None` keeps every leaf's dtype); `params_to_numpy` carries
a tree back (checkpoints, parity with the JAX package).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device="cuda", dtype=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    torch tensors on `device`. Integer leaves (int8 weights) keep their
    dtype; floating leaves are cast to `dtype` when it is given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def params_to_numpy(tree: Any) -> Any:
    """The reverse of `params_from_jax`: torch leaves -> numpy arrays on the
    host, the same structure. bf16 leaves become f32 (numpy has no bf16)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of a nested dict/list tree, in a fixed order
    (dict insertion order, depth first)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """Apply `fn` to every tensor leaf of a nested dict/list param tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
