"""Int8 weight-only quantization (port of kalle_tpu/ops/quant.py:31-113).

Per-output-channel absmax int8: the scale multiplies the matmul OUTPUT,
(x @ w_q) * scale == x @ (w_q * scale), so the weights stay int8 in device
memory. Group-wise int4 and `fuse_decode_params` are not ported yet.

`qmatmul` here is the plain path (prefill, CPU); the t=1 decode step on
the card streams the int8 weights through `ops/kernels/qmm.py`.
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


def qmatmul(x: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (..., in) @ int8 weight -> (..., out) in x.dtype, scaled per
    output channel in f32."""
    q, scale = wq["q"], wq["scale"]
    if scale.dim() == q.dim():
        raise NotImplementedError("group-wise (int4) scales are not ported")
    y = torch.matmul(x, q.to(x.dtype))
    return (y.float() * scale).to(x.dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "q" in p and "scale" in p


def quantize_llama_params(params: dict, bits: int = 8) -> dict:
    """Quantize the per-layer matrices of a Llasa tree ({'llama': ...}) or
    a bare llama tree, keeping the leading L axis. Embeddings, norms and
    heads stay dense."""
    if bits != 8:
        raise NotImplementedError("only int8 is ported (int4 is queued)")
    bare = "llama" not in params
    tree = {"llama": params} if bare else dict(params)
    layers = dict(tree["llama"]["layers"])
    for k in QUANT_KEYS:
        w = layers[k]  # (L, in, out)
        absmax = w.abs().amax(dim=1).float()  # (L, out)
        scale = absmax.clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(w.float() / scale[:, None, :]), -127, 127)
        layers[k] = {"q": q.to(torch.int8), "scale": scale}
    tree["llama"] = dict(tree["llama"], layers=layers)
    return tree["llama"] if bare else tree


def maybe_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Dense or quantized matmul, dispatched on the param structure."""
    if is_quantized(w):
        return qmatmul(x, w)
    return x @ w.to(x.dtype)
