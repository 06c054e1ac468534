"""Parameter bridge: a JAX param tree, already converted to numpy, -> torch.

The port keeps the JAX package's parameter layouts at rest, so a tree moves
across leaf by leaf with its structure unchanged:

  * Llama layers stay stacked on a leading L axis (`layers/wq` is
    (L, in, out), kalle_tpu/models/lm/llama.py:134-158);
  * int8 weights stay `{'q': int8 (L, in, out), 'scale': f32 (L, out)}`
    dicts (kalle_tpu/ops/quant.py:74-106); int4 weights keep their
    group-wise `{'q', 'scale' (L, in // group, out)}` dicts, but torch has
    no int4 dtype: a JAX int4 leaf (ml_dtypes `int4`) becomes an int8
    tensor of the same values, and `params_to_numpy` turns the q of a
    group-wise dict back into `int4` (ml_dtypes, imported only then);
  * the Llasa heads keep `audio_linear/{w,b}` and
    `distribution_linear/{w0,b0,w2,b2}` with (in, out) weights
    (kalle_tpu/models/lm/llasa.py:46-66);
  * SigmaVAE convs stay NWC kernels (K, Cin/groups, Cout)
    (kalle_tpu/models/codecs/sigmavae.py:90-142); `ops/conv.py` takes them
    in that layout;
  * the codec discriminators keep `{"mpd": [stack], "mrd": [stack]}`, a
    stack a list of `{"w": (K, C_in, C_out), "b": (C_out,)}`
    (kalle_tpu/models/codecs/discriminators.py:54-83), so the JAX and the
    port's discriminators run one set of weights.

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
    elif a.dtype.name == "int4":  # ml_dtypes int4: the same values, a byte each
        t = torch.from_numpy(a.astype(np.int8))
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
    host, the same structure. bf16 leaves become f32 (numpy has no bf16);
    the q of a group-wise (int4) quantized dict becomes ml_dtypes int4."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    if (isinstance(tree, dict) and set(tree) == {"q", "scale"}
            and tree["scale"].dim() == tree["q"].dim()):
        import ml_dtypes

        return {"q": leaf(tree["q"]).astype(ml_dtypes.int4), "scale": leaf(tree["scale"])}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return leaf(tree)


def state_array(v: Any) -> np.ndarray:
    """A torch state-dict entry (a torch tensor or a numpy array) -> an f32
    numpy array on the host, for the importers that fold and transpose
    weights in numpy before `params_from_jax`."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).cpu().numpy()
    return np.asarray(v, np.float32)


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
