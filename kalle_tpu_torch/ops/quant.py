"""Int8 / int4 weight-only quantization and the fused decode layout (port
of kalle_tpu/ops/quant.py).

int8: per-output-channel absmax scales; the scale multiplies the matmul
OUTPUT, (x @ w_q) * scale == x @ (w_q * scale), so the weights stay int8
in device memory.

int4: group-wise scales along the contraction (`group` inputs share one
scale per output column): y[o] = sum_g s[g, o] * (sum_i x[g, i] q[g, i, o]).
torch has no int4 dtype, so the values -7..7 are stored one a byte in
int8 tensors: the same values as the JAX package's int4 leaves
(`bridge.py` converts them), at the int8 layout's memory, so no memory is
saved yet. `qmatmul` tells the two apart by the scale's rank, as JAX does.

`fuse_decode_params` concatenates each layer's wq|wk|wv into `wqkv` and
wg|wu into `wgu` along the output dimension (dense or quantized, a Llasa
or a bare Llama tree): the same per-column products in one wide weight
each, so the decode step streams wqkv in one K2 launch and wgu through
K3's fused mode (`models/lm/llama.py`).

`qmatmul` here is the plain path (prefill, the CPU, and every group-wise
matmul: no hand-written kernel takes group-wise scales, as no Pallas
kernel of the JAX package does); the t=1 decode step on the card streams
per-channel int8 weights through `ops/kernels/qmm.py`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) -> {'q': int8 (in, out), 'scale': f32 (out,)}."""
    absmax = w.abs().amax(dim=0)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """(in, out) -> {'q': int4 values in int8 (in, out), 'scale': f32
    (in // group, out)}."""
    i, o = w.shape
    if i % group:
        raise ValueError(f"{i} inputs do not split into groups of {group}")
    wg = w.float().reshape(i // group, group, o)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0  # (n_groups, out)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return {"q": q.reshape(i, o).to(torch.int8), "scale": scale}


def is_grouped(w: Dict[str, torch.Tensor]) -> bool:
    """A quantized weight with group-wise (int4) scales."""
    return w["scale"].dim() == w["q"].dim()


def qmatmul(x: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (..., in) @ quantized weight -> (..., out) in x.dtype: per-channel
    (int8: scale (out,)) or group-wise (int4: scale (in // group, out)),
    told apart by the scale's rank. Products and sums in f32."""
    q, scale = wq["q"], wq["scale"]
    if is_grouped(wq):
        i, o = q.shape
        ng = scale.shape[0]
        xg = x.reshape(*x.shape[:-1], ng, i // ng).float()
        part = torch.einsum("...gi,gio->...go", xg, q.reshape(ng, i // ng, o).float())
        return (part * scale).sum(dim=-2).to(x.dtype)
    y = torch.matmul(x, q.to(x.dtype))
    return (y.float() * scale).to(x.dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "q" in p and "scale" in p


def quantize_llama_params(params: dict, bits: int = 8, group: int = 128) -> dict:
    """Quantize the per-layer matrices of a Llasa tree ({'llama': ...}) or
    a bare llama tree, keeping the leading L axis. Embeddings, norms and
    heads stay dense. bits=8: per-output-channel scales; bits=4: group-wise
    scales over min(group, in) contraction inputs."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}: 8 or 4")
    bare = "llama" not in params
    tree = {"llama": params} if bare else dict(params)
    layers = dict(tree["llama"]["layers"])
    for k in QUANT_KEYS:
        w = layers[k].float()  # (L, in, out)
        if bits == 4:
            L, i, o = w.shape
            grp = min(group, i)
            wg = w.reshape(L, i // grp, grp, o)
            scale = wg.abs().amax(dim=2).clamp_min(1e-8) / 7.0  # (L, n_groups, out)
            q = torch.clamp(torch.round(wg / scale[:, :, None, :]), -7, 7).reshape(L, i, o)
        else:
            scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0  # (L, out)
            q = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
        layers[k] = {"q": q.to(torch.int8), "scale": scale}
    tree["llama"] = dict(tree["llama"], layers=layers)
    return tree["llama"] if bare else tree


def maybe_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Dense or quantized matmul, dispatched on the param structure."""
    if is_quantized(w):
        return qmatmul(x, w)
    return x @ w.to(x.dtype)


def fuse_decode_params(params: dict) -> dict:
    """The decode layout: per layer wq|wk|wv -> `wqkv` and wg|wu -> `wgu`,
    concatenated along the output dimension (quantized weights: their q
    and scales alike). Dense or quantized, a Llasa tree or a bare llama
    tree; the other leaves are shared, not copied. The training and
    checkpoint layout keeps the separate matrices."""
    bare = "llama" not in params
    tree = {"llama": params} if bare else dict(params)
    layers = dict(tree["llama"]["layers"])

    def cat(ws):
        if is_quantized(ws[0]):
            return {"q": torch.cat([w["q"] for w in ws], dim=-1),
                    "scale": torch.cat([w["scale"] for w in ws], dim=-1)}
        return torch.cat(ws, dim=-1)

    layers["wqkv"] = cat([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")])
    layers["wgu"] = cat([layers.pop("wg"), layers.pop("wu")])
    tree["llama"] = dict(tree["llama"], layers=layers)
    return tree["llama"] if bare else tree
