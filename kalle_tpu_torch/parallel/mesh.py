"""Device mesh and parameter layouts over torch.distributed (port of
kalle_tpu/parallel/mesh.py).

SPMD: one process per device, every process runs the same program. The
mesh is a `DeviceMesh` with the JAX package's axis names and order —
(dp, tp[, sp]), or (dp, pp[, tp]) when pp > 1 — tp innermost so its
per-layer collectives join the nearest devices.

Layouts keep the JAX package's table (`param_pspecs`): a spec is a tuple
with one entry a dimension, None (replicated), an axis name, or a tuple
of names (the dimension split over their product, the first name major).
`shard_params` keeps each rank's block of every leaf; `gather_params`
puts the full tensors back together (checkpoints, tests).

The port applies the table to the Llama layer stack only. The embedding,
`audio_linear` and the head stay replicated: the numbers are the same
either way, and the layers hold 97% of the 1B model's parameters.

`layer_slice_constraint` has no counterpart: it only steers GSPMD's
resharding of the JAX layer scan, and here every layer's shards are
sliced and gathered by hand.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..bridge import tree_leaves
from ..ops.quant import is_quantized
from . import collectives

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"
PP_AXIS = "pp"

# gradients are all-reduced in flat buckets of at most this many elements
GRAD_BUCKET = 1 << 26

Spec = Tuple[Any, ...]


class Mesh:
    """A `DeviceMesh` with its axes looked up by name. An axis the mesh does
    not have has size 1, coordinate 0 and no group."""

    def __init__(self, device_mesh, device_type: str):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_type == "cuda" else torch.device(device_type))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        """This process's coordinate along `axis`."""
        return self.device_mesh.get_local_rank(axis) if axis in self.shape else 0

    def group(self, axis: str):
        return self.device_mesh.get_group(axis) if axis in self.shape else None

    def coords(self) -> Dict[str, int]:
        return {a: self.rank(a) for a in self.axis_names}


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1,
              device_type: str = "cuda") -> Mesh:
    """dp x tp (x sp) mesh over the initialized process group, or dp x pp
    (x tp) when pp > 1; dp == -1 takes the ranks the other axes leave.
    Raises when no process group is initialized, when the axes do not
    multiply to the world size, and when a cuda mesh asks for more ranks
    than this host has cards."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    n = dist.get_world_size()
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"a cuda mesh of {n} ranks on a host with "
                           f"{torch.cuda.device_count()} cards")
    from torch.distributed.device_mesh import init_device_mesh

    if pp > 1:
        if sp != 1:
            raise ValueError("pp does not compose with sp")
        if dp == -1:
            dp = n // (pp * tp)
        if dp * pp * tp != n:
            raise ValueError(f"dp({dp})*pp({pp})*tp({tp}) != world size ({n})")
        shape, names = ((dp, pp, tp), (DP_AXIS, PP_AXIS, TP_AXIS)) if tp > 1 else (
            (dp, pp), (DP_AXIS, PP_AXIS))
    else:
        if dp == -1:
            dp = n // (tp * sp)
        if dp * tp * sp != n:
            raise ValueError(f"dp({dp})*tp({tp})*sp({sp}) != world size ({n})")
        shape, names = ((dp, tp, sp), (DP_AXIS, TP_AXIS, SP_AXIS)) if sp > 1 else (
            (dp, tp), (DP_AXIS, TP_AXIS))
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=names), device_type)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def param_pspecs(fsdp: bool = False, pp: bool = False) -> dict:
    """The JAX package's layout table for the Llasa tree (mesh.py:108-166).

    Megatron tp: wq/wk/wv/wg/wu column-parallel (output dim over tp),
    wo/wd row-parallel (input dim over tp), norms replicated, layer leaves
    with a leading L axis. fsdp=True splits the tp dimension over tp x dp
    ((tp, dp)): weights and AdamW moments at rest drop to 1/(tp*dp). pp=True
    splits L over pp (stages own consecutive layers), tp as before; it
    excludes fsdp. The port uses the `layers` entries; see the module
    docstring for the rest."""
    if pp:
        if fsdp:
            raise ValueError("pp composes with dp (x tp) only, not fsdp")
        tp = TP_AXIS

        def lp(spec):
            return (PP_AXIS,) + spec
    else:
        tp = (TP_AXIS, DP_AXIS) if fsdp else TP_AXIS

        def lp(spec):
            return (None,) + spec

    return {
        "llama": {
            "embed": (None, tp),
            "layers": {
                "attn_norm": lp((None,)),
                "wq": lp((None, tp)), "wk": lp((None, tp)), "wv": lp((None, tp)),
                "wo": lp((tp, None)),
                "mlp_norm": lp((None,)),
                "wg": lp((None, tp)), "wu": lp((None, tp)),
                "wd": lp((tp, None)),
            },
            "final_norm": (None,),
        },
        "audio_linear": {"w": (None, tp), "b": (tp,)},
        "distribution_linear": {"w0": (tp, None), "b0": (None,),
                                "w2": (None, None), "b2": (None,)},
    }


def prune_spec(spec: Spec, axis_names) -> Spec:
    """Drop axis names absent from `axis_names` (those dimensions become
    replicated), so a table written for dp/tp/pp serves smaller meshes."""
    out = []
    for el in spec:
        if el is None:
            out.append(None)
        elif isinstance(el, tuple):
            kept = tuple(a for a in el if a in axis_names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(el if el in axis_names else None)
    return tuple(out)


def _names(el) -> Tuple[str, ...]:
    return () if el is None else (el if isinstance(el, tuple) else (el,))


def _extent(el, sizes: Dict[str, int]) -> int:
    return math.prod(sizes.get(a, 1) for a in _names(el))


def _divisible(spec: Spec, shape, sizes: Dict[str, int]) -> Spec:
    """Replicate the dimensions whose mesh extent does not divide them (a
    tiny model's single int4 group cannot split over tp)."""
    return tuple(el if dim % _extent(el, sizes) == 0 else None
                 for el, dim in zip(spec, shape))


def _quant_scale_spec(wspec: Spec, scale_ndim: int) -> Spec:
    """A quantization scale's spec from its weight's: group-wise (int4)
    scales, of the weight's rank with the contraction dim replaced by the
    groups, inherit it; per-channel (int8) scales, one rank lower, drop
    the contraction dim's entry."""
    if scale_ndim == len(wspec):
        return wspec
    return wspec[:-2] + wspec[-1:]


def leaf_specs(params: dict, sizes: Dict[str, int], fsdp: bool = False,
               pp: bool = False) -> dict:
    """The spec of every leaf of a Llasa tree (or a bare Llama tree) on a
    mesh of these axis sizes: the table's layer entries pruned to the mesh
    and made divisible, every other leaf replicated; quantized
    {'q','scale'} leaves expand to a spec each (q as the dense weight)."""
    bare = "llama" not in params
    layers = (params if bare else params["llama"])["layers"]
    if "wqkv" in layers or "wgu" in layers:
        raise ValueError("shard the separate wq/wk/wv and wg/wu, then fuse each rank's "
                         "parts (ops.quant.fuse_decode_params)")
    table = param_pspecs(fsdp=fsdp, pp=pp)["llama"]["layers"]
    names = set(sizes)

    def layer_spec(key, w):
        s = prune_spec(table[key], names)
        if not is_quantized(w):
            return _divisible(s, w.shape, sizes)
        q = _divisible(s, w["q"].shape, sizes)
        scale = _divisible(_quant_scale_spec(q, w["scale"].dim()), w["scale"].shape, sizes)
        grouped = w["scale"].dim() == w["q"].dim()
        if grouped and q[-2] is not None and scale[-2] is None and w["scale"].shape[-2] > 1:
            raise ValueError(f"{key}: {w['scale'].shape[-2]} int4 groups do not split "
                             f"over the {_extent(q[-2], sizes)} shards of their rows")
        return {"q": q, "scale": scale}

    def replicated(tree):
        if isinstance(tree, dict):
            return {k: replicated(v) for k, v in tree.items()}
        return (None,) * tree.dim()

    lspecs = {k: layer_spec(k, w) for k, w in layers.items()}
    if pp and sizes.get(PP_AXIS, 1) > 1:
        L = next(iter(tree_leaves(layers))).shape[0]
        if L % sizes[PP_AXIS]:
            raise ValueError(f"{L} layers do not split over {sizes[PP_AXIS]} stages")
    llama = {k: (lspecs if k == "layers" else replicated(v))
             for k, v in (params if bare else params["llama"]).items()}
    if bare:
        return llama
    return {k: (llama if k == "llama" else replicated(v)) for k, v in params.items()}


def _block(el, sizes: Dict[str, int], coords: Dict[str, int]) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a dimension split by `el`."""
    n, idx = 1, 0
    for a in _names(el):
        n, idx = n * sizes.get(a, 1), idx * sizes.get(a, 1) + coords.get(a, 0)
    return n, idx


def shard_leaf(x: torch.Tensor, spec: Spec, sizes: Dict[str, int],
               coords: Dict[str, int]) -> torch.Tensor:
    """The block of x at mesh coordinates `coords`, as its own contiguous
    tensor (the kernels take contiguous, aligned weights)."""
    for dim, el in enumerate(spec):
        n, idx = _block(el, sizes, coords)
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, idx * step, step)
    return x.contiguous().clone()


def spec_leaves(specs) -> List[Spec]:
    """The specs of a spec tree in `bridge.tree_leaves` order of its params
    (dicts flattened, the spec tuples kept whole)."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in spec_leaves(v)]
    return [specs]


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


@dataclass
class Layout:
    """A mesh and the spec of every parameter leaf: what the model, the
    train step and checkpoints need to know of the parallel layout."""

    mesh: Mesh
    specs: dict
    fsdp: bool = False

    # -- groups (None when the axis is absent or of size 1: the weight and
    # gradient collectives run only where they split something) --
    def group(self, axis: str):
        return self.mesh.group(axis) if self.mesh.size(axis) > 1 else None

    @property
    def tp(self):
        return self.group(TP_AXIS)

    @property
    def sp(self):
        return self.group(SP_AXIS)

    @property
    def layer_specs(self) -> dict:
        """The specs of the Llama layer stack."""
        return (self.specs["llama"] if "llama" in self.specs else self.specs)["layers"]

    # -- parameters --
    def shard(self, tree: dict) -> dict:
        """This rank's blocks of a full tree."""
        sizes, coords = self.mesh.shape, self.mesh.coords()
        return _map2(lambda x, s: shard_leaf(x, s, sizes, coords), tree, self.specs)

    def gather(self, tree: dict) -> dict:
        """The full tensors of a sharded tree (every rank calls it)."""
        return _map2(self.gather_leaf, tree, self.specs)

    def gather_leaf(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        with torch.no_grad():
            for dim, el in enumerate(spec):
                for a in reversed(_names(el)):  # innermost axis first
                    if self.mesh.size(a) > 1:
                        x = collectives.gather_dim(x, dim, self.mesh.group(a))
        return x

    def use_layer(self, lp: dict) -> dict:
        """fsdp: one layer's weights (the L axis taken off) all-gathered over
        dp at their use; their gradients reduce-scatter back to the shards.
        Identity without fsdp or when dp has one rank."""
        dp = self.group(DP_AXIS)
        if not self.fsdp or dp is None:
            return lp

        def use(w, spec):
            for dim, el in enumerate(spec[1:]):
                if DP_AXIS in _names(el):
                    return collectives.all_gather(w, dim, dp)
            return w

        return _map2(use, lp, self.layer_specs)

    # -- data --
    def rows(self, b_local: int) -> Tuple[int, int]:
        """(global rows, this rank's first row) for b_local rows a dp rank."""
        return b_local * self.mesh.size(DP_AXIS), b_local * self.mesh.rank(DP_AXIS)

    def seq_slice(self, t: int) -> Tuple[int, int]:
        """(first position, length) of this rank's part of a t-long sequence."""
        n = self.mesh.size(SP_AXIS)
        if t % n:
            raise ValueError(f"sequence length {t} does not split over sp={n}")
        return self.mesh.rank(SP_AXIS) * (t // n), t // n

    def global_noise(self, generator: torch.Generator, shape, device) -> torch.Tensor:
        """The N(0, 1) draw that one process would make for the global batch,
        cut to this rank's rows: every rank draws all of it."""
        total, first = self.rows(shape[0])
        full = torch.randn((total,) + tuple(shape[1:]), generator=generator,
                           device=device, dtype=torch.float32)
        return full[first:first + shape[0]]

    def sum_dp(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over dp (the batch's rows). Runs on one dp rank too: a
        few scalars a step, and a world-1 mesh still reduces over its group."""
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.mesh.group(DP_AXIS))
        return out

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over dp and sp: the per-rank shares of a batch loss."""
        out = self.sum_dp(x)
        if self.sp is not None:
            dist.all_reduce(out, group=self.sp)
        return out

    # -- gradients --
    def sync_grads(self, params: dict) -> None:
        """Sum every leaf's .grad over the ranks that hold the same leaf and
        saw other data: dp (less the fsdp leaves, whose gathers'
        reduce-scatter did it) and sp, where they have more than one rank.
        Flat buckets, a few collectives."""
        pairs = list(zip(tree_leaves(params), spec_leaves(self.specs)))
        dp = self.group(DP_AXIS)
        if dp is not None:
            _bucketed_all_reduce([p.grad for p, s in pairs
                                  if not any(DP_AXIS in _names(el) for el in s)], dp)
        if self.sp is not None:
            _bucketed_all_reduce([p.grad for p, _ in pairs], self.sp)

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """sqrt(sum of squares) of the full gradient: each leaf's norm
        reduced over the axes (of size > 1) it is sharded on, a replicated
        leaf counted once; the same arithmetic as optim.global_norm on one
        process."""
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, spec in enumerate(spec_leaves(self.specs)):
            axes = tuple(sorted({a for el in spec for a in _names(el)
                                 if self.mesh.size(a) > 1}))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            sq = torch.stack([norms[i] for i in idx]) ** 2
            for a in axes:
                dist.all_reduce(sq, group=self.mesh.group(a))
            for i, v in zip(idx, sq.sqrt()):
                norms[i] = v
        return torch.linalg.vector_norm(torch.stack(norms))


def _bucketed_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """all_reduce (sum) a list of tensors in place through flat buckets of
    one dtype and at most GRAD_BUCKET elements."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for t in ts + [None]:
            if bucket and (t is None or size + t.numel() > GRAD_BUCKET):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel()


def param_layout(params: dict, mesh: Mesh, fsdp: bool = False, pp: bool = False) -> Layout:
    """The Layout of a full Llasa tree on `mesh`."""
    return Layout(mesh, leaf_specs(params, mesh.shape, fsdp=fsdp, pp=pp), fsdp=fsdp)


def shard_params(params: dict, mesh: Mesh, fsdp: bool = False, pp: bool = False) -> dict:
    """This rank's blocks of the full params (on every rank the same tree:
    `bridge.params_from_jax`, or `init_params` from one seed)."""
    return param_layout(params, mesh, fsdp=fsdp, pp=pp).shard(params)


def gather_params(params: dict, layout: Layout) -> dict:
    """The inverse of `shard_params` (every rank calls it)."""
    return layout.gather(params)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, leading_accum: bool = False) -> dict:
    """This rank's dp rows of a global batch: dimension 0, or 1 for (A, B,
    ...) microbatch stacks. Non-array entries pass through."""
    dim = 1 if leading_accum else 0
    n, r = mesh.size(DP_AXIS), mesh.rank(DP_AXIS)
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape"):
            out[k] = v
            continue
        if v.shape[dim] % n:
            raise ValueError(f"{k}: {v.shape[dim]} rows do not split over dp={n}")
        step = v.shape[dim] // n
        idx = [slice(None)] * v.ndim
        idx[dim] = slice(r * step, (r + 1) * step)
        out[k] = v[tuple(idx)]
    return out


def data_shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(shard index, shard count) of this rank's data: its dp coordinate;
    the tp, sp and pp ranks of one dp rank read the same rows."""
    return (0, 1) if mesh is None else (mesh.rank(DP_AXIS), mesh.size(DP_AXIS))

