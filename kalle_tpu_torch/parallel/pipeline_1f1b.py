"""1F1B (one-forward-one-backward) pipeline schedule over a pp process
group (port of kalle_tpu/parallel/pipeline_1f1b.py).

GPipe (parallel/pipeline.py) keeps every microbatch's stage graph until
its backward. 1F1B starts a stage's backward work as soon as its first
microbatch returns from downstream, so at most S stage inputs are in
flight at any M: a memory optimisation that allows M >> S microbatches,
which is what shrinks the bubble ((S-1)/(M+S-1) either way).

The tick rule (JAX :20-27): all stages run 2(M + S - 1) ticks; at stage
s the forward of microbatch m fires at tick s + 2m and its backward at
tick 2S - 1 - s + 2m, so each stage does at most one unit a tick (F, B,
F, B in the steady state). A unit's operand always arrives on the tick
before: activations from stage s - 1, cotangents from stage s + 1.

A forward unit runs the stage without a graph and keeps its input in a
ring of S slots (the O(S) bound). A backward unit recomputes the stage's
forward from the saved input with a graph, as the JAX package's
`jax.vjp` does, and differentiates it: on the last stage through the head
and the loss (`head_loss_fn`, seeded with 1), elsewhere seeded with the
cotangent from stage s + 1. The whole schedule runs in the forward of an
autograd Function, which keeps the gradients and scales them by the
incoming loss cotangent in its backward (the JAX custom_vjp).

After the schedule the loss, the metrics and the head's gradients (made
on the last stage) and stage 0's input cotangents are summed over pp, so
every stage returns the same; the layers' gradients stay with their
stage. dp reductions are the caller's (train/step.py). tp composes: the
stage's tp collectives run the same schedule on every tp rank of a stage.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..bridge import tree_leaves
from .pipeline import _rebuild, _Transit


class _OneFOneB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, head_loss_fn, aux_keys, layer_tree, head_tree, n_mb, group,
                stats, n_layer, x, *leaves):
        tr = _Transit(group)
        s, n_st = tr.stage, len(tr.ranks)
        last = s == n_st - 1
        x_mb = x.reshape((n_mb, x.shape[0] // n_mb) + x.shape[1:])
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        layers = _rebuild(layer_tree, params[:n_layer])
        head = _rebuild(head_tree, params[n_layer:])
        wants = [p for p in params[:n_layer] if p.requires_grad] + (
            [p for p in params[n_layer:] if p.requires_grad] if last else [])
        grads = [torch.zeros_like(p) for p in wants]
        dx = torch.zeros_like(x_mb)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        aux: Dict[str, torch.Tensor] = {}
        ring = [None] * n_st
        live = max_live = 0
        for t in range(2 * (n_mb + n_st - 1)):
            tf, tb = t - s, t - (2 * n_st - 1 - s)
            f_act = tf >= 0 and tf % 2 == 0 and tf // 2 < n_mb
            b_act = tb >= 0 and tb % 2 == 0 and tb // 2 < n_mb
            if f_act:
                m = tf // 2
                h = x_mb[m] if s == 0 else tr.recv(x_mb[m], s - 1)
                if ring[m % n_st] is not None:
                    raise RuntimeError("1F1B ring overrun")
                ring[m % n_st] = h
                live += 1
                max_live = max(max_live, live)
                if not last:
                    with torch.no_grad():
                        tr.send(stage_fn(h, layers, m), s + 1)
            if b_act:
                m = tb // 2
                h = ring[m % n_st].detach().requires_grad_(True)
                ring[m % n_st] = None
                with torch.enable_grad():
                    y = stage_fn(h, layers, m)
                    if last:
                        l, aux_m = head_loss_fn(head, y, m)
                        out, seed = l, torch.ones_like(l)
                    else:
                        out, seed = y, tr.recv(y, s + 1)
                    got = torch.autograd.grad(out, [h] + wants, seed, allow_unused=True)
                live -= 1
                for acc, d in zip(grads, got[1:]):
                    if d is not None:
                        acc.add_(d)
                if last:
                    loss += l.detach().float()
                    for k, v in aux_m.items():
                        aux[k] = aux.get(k, 0) + v.detach().float()
                if s > 0:
                    tr.send(got[0], s - 1)
                else:
                    dx[m] = got[0]
        tr.close()
        if stats is not None:
            stats["max_live"] = max(stats.get("max_live", 0), max_live)

        # the loss, metrics and head grads come from the last stage, dx from
        # stage 0: a sum over pp gives every stage the same
        scal = torch.stack([loss] + [aux.get(k, torch.zeros_like(loss)) for k in aux_keys])
        dist.all_reduce(scal, group=group)
        dist.all_reduce(dx, group=group)
        head_wants = [p for p in params[n_layer:] if p.requires_grad]
        head_grads = grads[len(grads) - len(head_wants):] if last else [
            torch.zeros_like(p) for p in head_wants]
        for g in head_grads:
            dist.all_reduce(g, group=group)
        layer_grads = grads[:len(grads) - len(head_wants)] if last else grads
        it_l, it_h = iter(layer_grads), iter(head_grads)
        ctx.grads = [(next(it_l) if p.requires_grad else None) for p in params[:n_layer]] + [
            (next(it_h) if p.requires_grad else None) for p in params[n_layer:]]
        ctx.dx = dx.reshape(x.shape)
        outs = tuple(scal[1:])
        ctx.mark_non_differentiable(*outs)
        return (scal[0],) + outs

    @staticmethod
    def backward(ctx, dloss, *_):
        scale = lambda g: None if g is None else (g * dloss).to(g.dtype)  # noqa: E731
        return (None,) * 9 + (scale(ctx.dx),) + tuple(scale(g) for g in ctx.grads)


def pipeline_1f1b_loss(stage_fn: Callable, head_loss_fn: Callable, aux_keys, layers: dict,
                       head_params: dict, x: torch.Tensor, n_microbatches: int,
                       group, stats: Optional[dict] = None):
    """-> (loss, {metric: value}): the sum over microbatches m of
    head_loss_fn(head_params, stage stack(x_m), m), through the 1F1B
    schedule over `group` (pp). stage_fn(h, layers, m) applies this stage's
    layers to microbatch m's activations; head_loss_fn returns (microbatch
    m's share of the loss, {metric: share} for the names in `aux_keys`):
    the shares must sum to the batch's values, so fold global masked-mean
    denominators in. Differentiable in x, `layers` and `head_params`.
    `stats`, when given, receives "max_live": the most stage inputs this
    rank held at once."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"{b} rows do not split into {n_microbatches} microbatches")
    lleaves, hleaves = tree_leaves(layers), tree_leaves(head_params)
    aux_keys = tuple(aux_keys)
    out = _OneFOneB.apply(stage_fn, head_loss_fn, aux_keys, layers, head_params,
                          n_microbatches, group, stats, len(lleaves), x, *lleaves, *hleaves)
    return out[0], dict(zip(aux_keys, out[1:]))
