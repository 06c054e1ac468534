"""K5-K7: causal GQA flash attention with a (b, t) key-padding mask,
forward and backward, for the training forward.

Mirrors kalle_tpu/ops/pallas/flash_attention.py: `flash_attention` is a
`torch.autograd.Function` whose forward is K5 (`flash_fwd`, O and the
log-sum-exp rows) and whose backward is K6 (`flash_bwd_dq`) and K7
(`flash_bwd_dkv`, dK/dV summed over each GQA group inside the kernel).
delta = rowsum(dO * O) stays a plain tensor op, as on the TPU.

On CUDA tensors the wrappers launch `csrc/flash_attention.cu`; on CPU
tensors they run the plain versions below, which write out the same math:
masked scores (-1e30), p = exp(s - m) with masked p exactly 0, LSE = -1e30
and O = 0 on a row with no valid key, p = exp(s - LSE) recomputed in the
backward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

LIB = "flash_attention"
NAME_FWD, NAME_DQ, NAME_DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_P, _I = _build.P, _build.I
_SIGS = {"kt_flash_fwd": [_P] * 6 + [_I] * 6 + [_P],
         "kt_flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_P],
         "kt_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_P]}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, pad):
    """q * hd^-0.5 (b, t, nq, hd) f32, k repeated over each group, the
    masked scores (b, nq, t, t) and the mask (causal and key padding)."""
    b, t, nq, hd = q.shape
    qs = q.float() * hd ** -0.5
    kf = k.float().repeat_interleave(nq // k.shape[2], dim=2)
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, None] & pad.bool()[:, None, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    return qs, kf, torch.where(mask, s, NEG), mask


def _group_sum(x: torch.Tensor, nkv: int) -> torch.Tensor:
    """(b, t, nq, hd) per query head -> (b, t, nkv, hd) summed over groups."""
    b, t, nq, hd = x.shape
    return x.reshape(b, t, nkv, nq // nkv, hd).sum(3)


def flash_attention_fwd_plain(q, k, v, pad) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> o (b, t, nq, hd) in q's dtype, lse (b, nq, t) f32."""
    _, _, s, mask = _scores(q, k, pad)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vf = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.clamp_min(1e-30).transpose(1, 2)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG)[..., 0]
    return o.to(q.dtype), lse


def _p_ds(q, k, v, pad, do, lse, delta):
    qs, kf, s, mask = _scores(q, k, pad)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    vf = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return qs, kf, p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, pad, do, lse, delta) -> torch.Tensor:
    """dQ = scale * sum_k ds * k, in q's dtype."""
    _, kf, _, ds = _p_ds(q, k, v, pad, do, lse, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, pad, do, lse, delta):
    """dK = sum_q ds^T (scale * q), dV = sum_q p^T dO, summed over each GQA
    group in f32, in k's / v's dtype."""
    qs, _, p, ds = _p_ds(q, k, v, pad, do, lse, delta)
    nkv = k.shape[2]
    dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, qs), nkv)
    dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do.float()), nkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) -> (b, nq, t) f32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, pad, o, lse, do):
    """-> dq, dk, dv of the loss whose output cotangent is `do`."""
    delta = attention_delta(o, do)
    return (flash_bwd_dq_plain(q, k, v, pad, do, lse, delta),
            *flash_bwd_dkv_plain(q, k, v, pad, do, lse, delta))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, pad, *rest) -> None:
    b, t, nq, hd = q.shape
    nkv = k.shape[2] if k.dim() == 4 else 0
    if not (q.dtype in (torch.bfloat16, torch.float32) and k.dtype == v.dtype == q.dtype
            and k.shape == v.shape == (b, t, nkv, hd) and nkv > 0 and nq % nkv == 0
            and hd in HEAD_DIMS and pad.dtype == torch.int32 and pad.shape == (b, t)
            and b * nq <= 65535 and all(x.dtype == torch.float32 and x.shape == (b, nq, t)
                                        for x in rest[1:])
            and (not rest or (rest[0].dtype == q.dtype and rest[0].shape == q.shape))
            and _build.aligned(q, k, v, *rest) and pad.is_contiguous()):
        raise ValueError(
            "flash attention takes contiguous, 32-byte aligned q (b, t, nq, hd) and k, v "
            "(b, t, nkv, hd) of one dtype (bf16 or f32), nq % nkv == 0, hd in "
            f"{HEAD_DIMS}, an int32 (b, t) pad mask, dO like q and f32 (b, nq, t) "
            "LSE and delta; got " + _build.describe(q, k, v, pad, *rest))


def _dims(q, k):
    b, t, nq, hd = q.shape
    return b, t, nq, k.shape[2], hd, int(q.dtype == torch.bfloat16), _build.stream()


def flash_fwd(q, k, v, pad) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: -> o (b, t, nq, hd), lse (b, nq, t) f32. pad: (b, t), int32 on
    the card."""
    if _build.on_cpu(q, k, v, pad):
        return flash_attention_fwd_plain(q, k, v, pad)
    _check(q, k, v, pad)
    b, t, nq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, nq, t), dtype=torch.float32, device=q.device)
    lib = _build.load(LIB, _SIGS)
    rc = lib.kt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), *_dims(q, k))
    _build.check(lib, rc, NAME_FWD)
    _build.count(NAME_FWD)
    return o, lse


def flash_bwd_dq(q, k, v, pad, do, lse, delta) -> torch.Tensor:
    """K6: -> dq (b, t, nq, hd)."""
    if _build.on_cpu(q, k, v, pad, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, pad, do, lse, delta)
    _check(q, k, v, pad, do, lse, delta)
    dq = torch.empty_like(q)
    lib = _build.load(LIB, _SIGS)
    rc = lib.kt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dq.data_ptr(), *_dims(q, k))
    _build.check(lib, rc, NAME_DQ)
    _build.count(NAME_DQ)
    return dq


def flash_bwd_dkv(q, k, v, pad, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: -> dk, dv (b, t, nkv, hd), each GQA group summed in the kernel."""
    if _build.on_cpu(q, k, v, pad, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, pad, do, lse, delta)
    _check(q, k, v, pad, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load(LIB, _SIGS)
    rc = lib.kt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(), *_dims(q, k))
    _build.check(lib, rc, NAME_DKV)
    _build.count(NAME_DKV)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad):
        o, lse = flash_fwd(q, k, v, pad)
        ctx.save_for_backward(q, k, v, pad, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = flash_bwd_dq(q, k, v, pad, do, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, pad, do, lse, delta)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: torch.Tensor, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Differentiable causal flash attention with a key-padding mask and GQA.
    q (b, t, nq, hd); k, v (b, t, nkv, hd); pad_mask (b, t), nonzero = a
    real key. t must be a multiple of the block sizes (capped at t), as in
    the JAX package; the kernels tile internally."""
    t = q.shape[1]
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq len {t} must be a multiple of the block sizes "
                         f"({block_q}, {block_k}): pad to a bucket")
    if pad_mask.device.type == "cuda":
        pad_mask = pad_mask.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, pad_mask)
