"""GPipe pipeline parallelism over a pp process group (port of
kalle_tpu/parallel/pipeline.py:50-149).

The stacked Llama layers (L, ...) are split over S = pp stages, each rank
holding L/pp consecutive layers. The batch's M microbatches stream
through the stages: at tick t stage s runs microbatch t - s and sends its
output to stage s + 1 (M + S - 1 ticks). The last stage's outputs are
broadcast to every stage (the JAX package's psum-broadcast), so every
stage goes on to the same head and loss.

The backward runs the ticks in reverse: stage s takes microbatch m's
output cotangent (the last stage from the loss, the others from stage s +
1), differentiates its saved forward graph and sends the input cotangent
to stage s - 1. Stage 0's input cotangents are broadcast back to every
stage, so the embedding upstream gets the same gradient everywhere. Every
microbatch's stage graph is live until its backward, as in GPipe; with
LlamaConfig.remat each layer of the stage is checkpointed and recomputed.

Every stage holds the batch's rows (the embedding runs on every stage), so
only activations and cotangents travel; a stage reads its microbatch's
masks locally. tp composes: the stage function's tp collectives run the
same schedule on every tp rank of a stage. sp does not (make_mesh).
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from ..bridge import tree_leaves


def _rebuild(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(tree)


class _Transit:
    """Point-to-point sends and receives between neighbouring stages: sends
    are posted without waiting and waited for at `close`, so a stage blocks
    only on the receives whose sends were posted on earlier ticks."""

    def __init__(self, group):
        self.ranks = dist.get_process_group_ranks(group)
        self.stage = self.ranks.index(dist.get_rank())
        self.pending: list = []

    def send(self, x: torch.Tensor, stage: int) -> None:
        x = x.detach().contiguous()
        self.pending.append((dist.isend(x, self.ranks[stage]), x))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        out = torch.empty_like(like)
        dist.recv(out, self.ranks[stage])
        return out

    def close(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending = []


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, n_mb, group, x, *leaves):
        tr = _Transit(group)
        s, n_st = tr.stage, len(tr.ranks)
        x_mb = x.reshape((n_mb, x.shape[0] // n_mb) + x.shape[1:])
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        layers = _rebuild(tree, params)
        out = torch.zeros_like(x_mb)
        saved = [None] * n_mb
        with torch.enable_grad():
            for t in range(n_mb + n_st - 1):
                m = t - s
                if not 0 <= m < n_mb:
                    continue
                h = x_mb[m] if s == 0 else tr.recv(x_mb[m], s - 1)
                h = h.detach().requires_grad_(True)
                y = stage_fn(h, layers, m)
                saved[m] = (h, y)
                if s < n_st - 1:
                    tr.send(y, s + 1)
                else:
                    out[m] = y.detach()
        tr.close()
        dist.broadcast(out, tr.ranks[-1], group=group)
        ctx.saved, ctx.params, ctx.group, ctx.n_mb = saved, params, group, n_mb
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        tr = _Transit(ctx.group)
        s, n_st, n_mb = tr.stage, len(tr.ranks), ctx.n_mb
        dy_mb = dy.reshape((n_mb, dy.shape[0] // n_mb) + dy.shape[1:])
        wants = [p for p in ctx.params if p.requires_grad]
        grads = [torch.zeros_like(p) for p in wants]
        dx = torch.zeros_like(dy_mb)
        for t in reversed(range(n_mb + n_st - 1)):
            m = t - s
            if not 0 <= m < n_mb:
                continue
            g = dy_mb[m] if s == n_st - 1 else tr.recv(dy_mb[m], s + 1)
            h, y = ctx.saved[m]
            ctx.saved[m] = None
            got = torch.autograd.grad(y, [h] + wants, g, allow_unused=True)
            for acc, d in zip(grads, got[1:]):
                if d is not None:
                    acc.add_(d)
            if s > 0:
                tr.send(got[0], s - 1)
            else:
                dx[m] = got[0]
        tr.close()
        dist.broadcast(dx, tr.ranks[0], group=ctx.group)
        it = iter(grads)
        out = [next(it) if p.requires_grad else None for p in ctx.params]
        return (None, None, None, None, dx.reshape(dy.shape), *out)


def pipelined_layer_stack(stage_fn: Callable, layers: dict, x: torch.Tensor,
                          n_microbatches: int, group) -> torch.Tensor:
    """Run this stage's `layers` (L / pp of the stack) as one stage of a GPipe
    pipeline over `group` (the pp group). stage_fn(h, layers, m) applies
    the layers to microbatch m's activations h (mb, t, h). x (b, t, h) is
    the whole batch, the same on every stage; returns the processed batch,
    the same on every stage. Differentiable in x and in `layers`."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"{b} rows do not split into {n_microbatches} microbatches")
    leaves = tree_leaves(layers)
    return _GPipe.apply(stage_fn, layers, n_microbatches, group, x, *leaves)
