"""K1: t=1 GQA decode attention over the layer-stacked KV cache.

`decode_attention_cached` mirrors kalle_tpu/ops/pallas/decode_attention.py
:217 (without the serving sideband column). On CUDA tensors it launches
`csrc/decode_attention.cu`; on CPU tensors it runs
`decode_attention_plain`, which repeats the kernel's arithmetic in PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..attention import NEG_INF
from . import _build

NAME = "decode_attention"
_SIGS = {"kt_decode_attention": [_build.P] * 7 + [_build.I] * 7 + [_build.P]}


def decode_attention_plain(q: torch.Tensor, k_full: torch.Tensor,
                           v_full: torch.Tensor, li: int, mask: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, nq, hd); k_full (L, B, nkv, hd, C) transposed keys; v_full
    (L, B, nkv, C, hd); mask (B, C) True = may attend; optional int8-cache
    scales (L, B, nkv, 1, C): K's on the score columns, V's on p."""
    b, nq, hd = q.shape
    kt, v = k_full[li].float(), v_full[li].float()
    nkv = kt.shape[1]
    s = torch.einsum("bkgd,bkdc->bkgc",
                     q.float().reshape(b, nkv, nq // nkv, hd), kt) * hd ** -0.5
    if k_scale is not None:
        s = s * k_scale[li]
    s = torch.where(mask.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[li]
    return torch.einsum("bkgc,bkcd->bkgd", p, v).reshape(b, nq, hd).to(q.dtype)


def decode_attention_cached(q: torch.Tensor, k_full: torch.Tensor,
                            v_full: torch.Tensor, li: int, mask: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode frame of attention reading layer `li` of the full cache
    -> (B, nq, hd) in q's dtype. See `decode_attention_plain`."""
    tensors = [q, k_full, v_full, mask] + [t for t in (k_scale, v_scale)
                                           if t is not None]
    if _build.on_cpu(*tensors):
        return decode_attention_plain(q, k_full, v_full, li, mask,
                                      k_scale, v_scale)
    b, nq, hd = q.shape
    L, bk, nkv, hdk, c = k_full.shape
    quant = k_full.dtype == torch.int8
    scales = tensors[4:]
    if not (q.dtype in (torch.bfloat16, torch.float32)
            and k_full.dtype == v_full.dtype and k_full.dtype in (q.dtype, torch.int8)
            and bk == b and hdk == hd and nq % nkv == 0 and nq // nkv <= 8 and hd <= 128
            and v_full.shape == (L, b, nkv, c, hd)
            and mask.dtype == torch.bool and mask.shape == (b, c) and 0 <= li < L
            and len(scales) == (2 if quant else 0)
            and all(s.dtype == torch.float32 and s.shape == (L, b, nkv, 1, c) for s in scales)
            and all(t.is_contiguous() for t in tensors)):
        raise ValueError(
            "decode_attention_cached takes contiguous q (B, nq, hd) bf16/f32, "
            "k (L, B, nkv, hd, C) and v (L, B, nkv, C, hd) of q's dtype or int8 "
            "with f32 (L, B, nkv, 1, C) scales, a bool (B, C) mask, nq/nkv <= 8, "
            f"hd <= 128, 0 <= li < L; got li={li}, " + _build.describe(*tensors))

    out = torch.empty_like(q)
    lib = _build.load(NAME, _SIGS)

    def layer(t):
        return None if t is None else t.data_ptr() + li * t.stride(0) * t.element_size()

    rc = lib.kt_decode_attention(
        q.data_ptr(), layer(k_full), layer(v_full), mask.data_ptr(),
        layer(k_scale), layer(v_scale), out.data_ptr(), b, nkv, nq // nkv, hd, c,
        int(q.dtype == torch.bfloat16), int(quant), _build.stream())
    _build.check(lib, rc, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
