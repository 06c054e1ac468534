"""K2 `qmm` and K3 `fused_mlp`: the decode step's weight stream.

Mirror kalle_tpu/ops/pallas/qmm.py:54 `qmm` and :114 `fused_mlp`. On CUDA
tensors they launch `csrc/qmm.cu`: bf16 activations with int8 or bf16
weights on the tensor cores, or f32 activations with int8 or f32 weights
in full f32 (the mode small f32 configs reach), any number of rows M in
one call and one count a call (K3's bf16 path is its MLP kernel and, when
it runs more than one cluster, a small kernel that sums the clusters'
partial outputs). Both read x as it is: the kernels zero the rows past M
themselves. On CPU tensors they run the plain versions below, which
repeat the kernels' arithmetic in PyTorch.

K3 has a fused mode for the decode layout of `ops.quant.fuse_decode_params`:
`fused_mlp(x, wgu, None, wd)` takes wg and wu as the two halves of one
(H, 2F) matrix `wgu` (and its (2F,) scales). The kernel then reads the
weight rows at a stride of 2F and the up half from column F; nothing else
changes, so at one F it gives the bits of the unfused call. It counts as
`fused_mlp_gu`. K2 needs no mode for `wqkv`: it is one (H, 3072) weight.
Group-wise (int4) scales are taken by neither kernel (a ValueError):
`models/lm/llama.py` routes them to `ops.quant.qmatmul`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

NAME_QMM = "qmm"
NAME_MLP = "fused_mlp"
NAME_MLP_GU = "fused_mlp_gu"
_P, _I = _build.P, _build.I
_SIGS = {"kt_qmm": [_P] * 4 + [_I] * 5 + [_P],
         "kt_fused_mlp": [_P] * 9 + [_I] * 6 + [_P],
         "kt_fused_mlp_plan": [_I] * 5 + [_P]}
# activation dtype -> the weight dtypes the kernels take with it
_WEIGHTS = {torch.bfloat16: (torch.int8, torch.bfloat16),
            torch.float32: (torch.int8, torch.float32)}


def _split(w) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    return (w["q"], w["scale"]) if isinstance(w, dict) else (w, None)


def _dequant_dot(x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w.astype(x.dtype) with f32 products, times the scale: f32."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    return y if scale is None else y * scale.float()


def qmm_plain(x: torch.Tensor, w: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) [int8 or dense] * scale (N,) -> (M, N) x.dtype."""
    return _dequant_dot(x, w, scale).to(x.dtype)


def _halves(wgu) -> Tuple[tuple, tuple]:
    """The (q, scale) pairs of the gate and up halves of a fused (H, 2F)
    weight, as views."""
    q, s = _split(wgu)
    f = q.shape[-1] // 2
    return (q[:, :f], None if s is None else s[:f]), (q[:, f:], None if s is None else s[f:])


def fused_mlp_plain(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """silu(x@wg) * (x@wu) @ wd; weights are {'q','scale'} dicts or dense
    matrices, and wu None takes wg as the fused (H, 2F) [wg | wu]. h is
    rounded to x.dtype and wd's scale applied once at the end, as in the
    kernel."""
    (gq, gs), (uq, us) = _halves(wg) if wu is None else (_split(wg), _split(wu))
    dq, ds = _split(wd)
    h = (F.silu(_dequant_dot(x, gq, gs)) * _dequant_dot(x, uq, us)).to(x.dtype)
    return _dequant_dot(h, dq, ds).to(x.dtype)


def _takes(x: torch.Tensor, weights, shapes) -> bool:
    """Whether the kernels take x and these (weight, scale) pairs: bf16 x
    (M >= 1, K) with weights of one dtype, int8 or bf16, or f32 x with int8
    or f32 weights, of the given shapes, all contiguous and 32-byte
    aligned, with contiguous, 16-byte aligned f32 (N,) scales or none."""
    return (x.dim() == 2 and x.dtype in _WEIGHTS and x.shape[0] >= 1
            and x.shape[1] == shapes[0][0] and _build.aligned(x)
            and len({w.dtype for w, _ in weights}) == 1
            and weights[0][0].dtype in _WEIGHTS[x.dtype]
            and all(w.shape == shape and _build.aligned(w)
                    and (s is None or (s.dtype == torch.float32 and s.shape == shape[1:]
                                       and s.is_contiguous() and s.data_ptr() % 16 == 0))
                    for (w, s), shape in zip(weights, shapes)))


def qmm(x: torch.Tensor, w: torch.Tensor,
        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) * scale (N,) -> (M, N) in x.dtype."""
    tensors = [x, w] + ([scale] if scale is not None else [])
    if _build.on_cpu(*tensors):
        return qmm_plain(x, w, scale)
    k, n = w.shape
    if not (_takes(x, [(w, scale)], [(k, n)]) and k % 64 == 0 and n % 32 == 0):
        raise ValueError("qmm takes contiguous x (M, K) with an int8 or same-dtype "
                         "(K, N) weight, x bf16 or f32, K % 64 == 0, N % 32 == 0 and an "
                         "f32 (N,) scale or none; got " + _build.describe(*tensors))
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load(NAME_QMM, _SIGS)
    rc = lib.kt_qmm(x.data_ptr(), w.data_ptr(), _build.ptr(scale), out.data_ptr(),
                    m, k, n, int(w.dtype == torch.int8), int(x.dtype == torch.float32),
                    _build.stream())
    _build.check(lib, rc, NAME_QMM)
    _build.count(NAME_QMM)
    return out


def fused_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """SwiGLU MLP in one weight pass: x (M, H) with wg, wu (H, F) and wd
    (F, H), each an int8 {'q','scale'} dict or a dense matrix of x's dtype;
    or, with wu None, wg the fused (H, 2F) [wg | wu] (K3's fused mode)."""
    fused = wu is None
    if fused:
        (gq, gs), (uq, us) = _split(wg), (None, None)
    else:
        (gq, gs), (uq, us) = _split(wg), _split(wu)
    dq, ds = _split(wd)
    tensors = [t for t in (x, gq, gs, uq, us, dq, ds) if t is not None]
    if _build.on_cpu(*tensors):
        return fused_mlp_plain(x, wg, wu, wd)
    h, f = dq.shape[1], dq.shape[0]
    pairs, shapes = ([(gq, gs), (dq, ds)], [(h, 2 * f), (f, h)]) if fused else (
        [(gq, gs), (uq, us), (dq, ds)], [(h, f), (h, f), (f, h)])
    if not (_takes(x, pairs, shapes) and h % 64 == 0 and f % 64 == 0):
        raise ValueError("fused_mlp takes contiguous x (M, H) and wg, wu (H, F) or one "
                         "(H, 2F) [wg | wu], wd (F, H) of one dtype, int8 with f32 (N,) "
                         "scales or x's dtype, x bf16 or f32, H % 64 == 0, F % 64 == 0; "
                         "got " + _build.describe(*tensors))
    if fused:  # the up half: column F of the same rows
        uq_ptr = gq.data_ptr() + f * gq.element_size()
        us_ptr = None if gs is None else gs.data_ptr() + f * gs.element_size()
    else:
        uq_ptr, us_ptr = uq.data_ptr(), _build.ptr(us)
    m = x.shape[0]
    f32 = x.dtype == torch.float32
    w_int8 = gq.dtype == torch.int8
    # scratch: the f32 mode's h (M, F), else the clusters' partial outputs
    scratch = torch.empty(fused_mlp_plan(m, h, f, w_int8, f32)["scratch_floats"],
                          dtype=torch.float32, device=x.device)
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    lib = _build.load(NAME_QMM, _SIGS)
    rc = lib.kt_fused_mlp(x.data_ptr(), gq.data_ptr(), _build.ptr(gs), uq_ptr, us_ptr,
                          dq.data_ptr(), _build.ptr(ds), scratch.data_ptr(), out.data_ptr(),
                          m, h, f, 2 * f if fused else f, int(w_int8), int(f32),
                          _build.stream())
    _build.check(lib, rc, NAME_MLP)
    _build.count(NAME_MLP_GU if fused else NAME_MLP)
    return out


_PLANS: Dict[tuple, Dict[str, int]] = {}


def fused_mlp_plan(m: int, h: int, f: int, w_int8: bool = True,
                   x_f32: bool = False) -> Dict[str, int]:
    """How K3 runs x (m, h) through weights of FFN width f on the current
    card: the f32 scratch it takes (floats), and for bf16 x the cluster
    size, the clusters a 64-row tile and the ring's stages. Asked of the
    kernel library once per shape and card, then cached."""
    key = (m, h, f, bool(w_int8), bool(x_f32), torch.cuda.current_device())
    plan = _PLANS.get(key)
    if plan is None:
        lib = _build.load(NAME_QMM, _SIGS)
        out = (ctypes.c_int * 4)()
        _build.check(lib, lib.kt_fused_mlp_plan(m, h, f, int(w_int8), int(x_f32), out),
                     NAME_MLP)
        plan = dict(zip(("scratch_floats", "cluster", "clusters", "stages"), out))
        _PLANS[key] = plan
    return plan
