"""K1: t=1 GQA decode attention over the layer-stacked KV cache.

`decode_attention_cached` mirrors kalle_tpu/ops/pallas/decode_attention.py
:217, its serving sideband column included, and `decode_attention` (:330)
its single-layer wrapper. On CUDA tensors it launches
`csrc/decode_attention.cu`; on CPU tensors it runs `decode_attention_plain`,
which repeats the kernel's arithmetic in PyTorch.

Launches are counted under `decode_attention`, and under
`decode_attention_sideband` for the sideband mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..attention import NEG_INF
from . import _build

NAME = "decode_attention"
NAME_SIDEBAND = "decode_attention_sideband"
_SIGS = {"kt_decode_attention": [_build.P] * 10 + [_build.I] * 7 + [_build.P]}


def decode_attention_plain(q: torch.Tensor, k_full: torch.Tensor,
                           v_full: torch.Tensor, li: int, mask: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None,
                           new_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, nq, hd); k_full (L, B, nkv, hd, C) transposed keys; v_full
    (L, B, nkv, C, hd); mask (B, C) True = may attend; optional int8-cache
    scales (L, B, nkv, 1, C): K's on the score columns, V's on p. The
    sideband k_new, v_new (B, nkv, hd) and new_valid (B,) add this step's
    column as one more key, scored NEG_INF where new_valid is False; `mask`
    is then the validity before this step."""
    b, nq, hd = q.shape
    kt, v = k_full[li].float(), v_full[li].float()
    nkv = kt.shape[1]
    qg = q.float().reshape(b, nkv, nq // nkv, hd)
    s = torch.einsum("bkgd,bkdc->bkgc", qg, kt) * hd ** -0.5
    if k_scale is not None:
        s = s * k_scale[li]
    s = torch.where(mask.bool()[:, None, None, :], s, NEG_INF)
    if k_new is None:
        p = torch.softmax(s, dim=-1)
        if v_scale is not None:
            p = p * v_scale[li]
        return torch.einsum("bkgc,bkcd->bkgd", p, v).reshape(b, nq, hd).to(q.dtype)
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * hd ** -0.5
    s_new = torch.where(new_valid.bool()[:, None, None], s_new, NEG_INF)
    p = torch.softmax(torch.cat([s, s_new[..., None]], dim=-1), dim=-1)
    out = (torch.einsum("bkgc,bkcd->bkgd", p[..., :-1], v)
           + p[..., -1:] * v_new.float()[:, :, None, :])
    return out.reshape(b, nq, hd).to(q.dtype)


def decode_attention_cached(q: torch.Tensor, k_full: torch.Tensor,
                            v_full: torch.Tensor, li: int, mask: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            k_new: Optional[torch.Tensor] = None,
                            v_new: Optional[torch.Tensor] = None,
                            new_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode frame of attention reading layer `li` of the full cache
    -> (B, nq, hd) in q's dtype. See `decode_attention_plain`. The
    sideband takes all three of k_new, v_new, new_valid, and no int8
    cache (as the JAX kernel asserts)."""
    side = [t for t in (k_new, v_new, new_valid) if t is not None]
    if side and (len(side) != 3 or k_scale is not None or v_scale is not None):
        raise ValueError("the sideband column takes k_new, v_new and new_valid together, "
                         "and no int8 cache scales")
    scales = [t for t in (k_scale, v_scale) if t is not None]
    tensors = [q, k_full, v_full, mask] + scales + side
    if _build.on_cpu(*tensors):
        return decode_attention_plain(q, k_full, v_full, li, mask, k_scale, v_scale,
                                      k_new, v_new, new_valid)
    b, nq, hd = q.shape
    L, bk, nkv, hdk, c = k_full.shape
    quant = k_full.dtype == torch.int8
    if not (q.dtype in (torch.bfloat16, torch.float32)
            and k_full.dtype == v_full.dtype and k_full.dtype in (q.dtype, torch.int8)
            and bk == b and hdk == hd and nq % nkv == 0 and hd <= 256
            and v_full.shape == (L, b, nkv, c, hd)
            and mask.dtype == torch.bool and mask.shape == (b, c) and 0 <= li < L
            and len(scales) == (2 if quant else 0)
            and all(s.dtype == torch.float32 and s.shape == (L, b, nkv, 1, c) for s in scales)
            and (not side or (k_new.dtype == v_new.dtype == k_full.dtype
                              and k_new.shape == v_new.shape == (b, nkv, hd)
                              and new_valid.dtype == torch.bool
                              and new_valid.shape == (b,)))
            and all(t.is_contiguous() for t in tensors)):
        raise ValueError(
            "decode_attention_cached takes contiguous q (B, nq, hd) bf16/f32, "
            "k (L, B, nkv, hd, C) and v (L, B, nkv, C, hd) of q's dtype or int8 "
            "with f32 (L, B, nkv, 1, C) scales, a bool (B, C) mask, nq % nkv == 0 "
            "(any group width), hd <= 256, 0 <= li < L, and for the sideband k_new, "
            "v_new (B, nkv, hd) "
            f"of the cache's dtype and a bool (B,) new_valid; got li={li}, "
            + _build.describe(*tensors))

    out = torch.empty_like(q)
    lib = _build.load(NAME, _SIGS)

    def layer(t):
        return None if t is None else t.data_ptr() + li * t.stride(0) * t.element_size()

    rc = lib.kt_decode_attention(
        q.data_ptr(), layer(k_full), layer(v_full), mask.data_ptr(),
        layer(k_scale), layer(v_scale), _build.ptr(k_new), _build.ptr(v_new),
        _build.ptr(new_valid), out.data_ptr(), b, nkv, nq // nkv, hd, c,
        int(q.dtype == torch.bfloat16), int(quant), _build.stream())
    name = NAME_SIDEBAND if side else NAME
    _build.check(lib, rc, name)
    _build.count(name)
    return out


def decode_attention(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Single-layer wrapper: kt (B, nkv, hd, C), v (B, nkv, C, hd) ->
    (B, nq, hd). See `decode_attention_cached`."""
    return decode_attention_cached(q, kt[None], v[None], 0, mask)
