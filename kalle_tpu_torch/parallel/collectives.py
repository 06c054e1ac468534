"""Differentiable collectives (the port's counterparts of `lax.psum` and
friends inside the JAX package's shard_map bodies).

Megatron's conjugate pair (kalle_tpu/models/lm/llama.py:170-197):
  * `copy_to(x, group)`  — f: identity forward, all-reduce backward. It
    marks a tp-replicated activation entering tp-local (column-parallel)
    compute, so the per-shard input cotangents are summed.
  * `reduce_from(x, group)` — g: all-reduce forward, identity backward. It
    sums the row-parallel partial outputs; the replicated output
    cotangent is each shard's partial cotangent.
`torch.distributed.nn.functional.all_reduce` is not used: its backward
all-reduces again, which counts a replicated cotangent once a rank.

`all_gather(x, dim, group)` concatenates the group's tensors along `dim`
in group-rank order; its backward reduce-scatters (sums the cotangents of
every rank's copy and keeps this rank's block). fsdp gathers weights with
it, sp the sequence.

Only calls that exist in torch 2.11 and 2.13 are used: `all_reduce`,
`all_gather_into_tensor`, `reduce_scatter_tensor`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's x concatenated along `dim`, contiguous (no autograd)."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum x over the group and keep this rank's block along `dim`,
    contiguous."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over `group` (identity when group is None)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over `group` (identity when group is None)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's x along `dim`; backward reduce-scatters
    (identity when group is None)."""
    return x if group is None else _AllGather.apply(x, dim, group)
