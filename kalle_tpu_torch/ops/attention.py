"""Attention ops (port of kalle_tpu/ops/attention.py:22-88).

Plain PyTorch: the JAX package computes these in XLA (prefill and the CPU
decode path), so they have no kernel. The t=1 decode step on the card goes
through `ops/kernels/decode_attention.py` instead.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def make_causal_padding_mask(pad_mask: torch.Tensor, q_len: int,
                             q_offset: int = 0) -> torch.Tensor:
    """Boolean (b, 1, q_len, kv_len) mask: True = may attend. Key positions
    with pad_mask == 0 are masked; causality uses absolute positions."""
    kv_len = pad_mask.shape[-1]
    dev = pad_mask.device
    q_pos = torch.arange(q_len, device=dev)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=dev)[None, :]
    causal = k_pos <= q_pos
    return causal[None, None] & pad_mask[:, None, None, :].bool()


def _softmax_pv(scores, v, mask, einsum_pv):
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(einsum_pv, probs.to(v.dtype), v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention with f32 scores and softmax.
    q (b, t_q, nq, hd); k, v (b, t_kv, nkv, hd); mask (b, 1, t_q, t_kv)."""
    b, t_q, nq, hd = q.shape
    nkv = k.shape[2]
    q = q.reshape(b, t_q, nkv, nq // nkv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * hd ** -0.5
    out = _softmax_pv(scores, v, mask, "bkgqs,bskd->bqkgd")
    return out.reshape(b, t_q, nq, hd)


def mha_t(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mha on the decode-cache layouts: kt (b, nkv, hd, t_kv) holds keys
    transposed per head, vt (b, nkv, t_kv, hd). Same math as mha."""
    b, t_q, nq, hd = q.shape
    nkv = kt.shape[1]
    out_dtype = q.dtype
    q = q.reshape(b, t_q, nkv, nq // nkv, hd)
    scores = torch.einsum("bqkgd,bkds->bkgqs", q.float(), kt.float()) * hd ** -0.5
    out = _softmax_pv(scores, vt, mask, "bkgqs,bksd->bqkgd")
    return out.reshape(b, t_q, nq, hd).to(out_dtype)
