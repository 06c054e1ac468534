"""K4: one fused SigmaVAE ConvNeXt residual block.

Mirrors kalle_tpu/ops/pallas/convnext_block.py:61 `fused_convnext_block`:
RMSNorm -> causal depthwise conv (k=7) + bias -> 1x1 up to 2H + bias ->
v * gelu_tanh(g) -> 1x1 down + bias -> residual. On CUDA tensors it
launches `csrc/convnext_block.cu` (bf16, any C and hidden width H =
mlp_ratio * C: tensor-core instances for C in {16, ..., 512} with H = 2C,
a generic one for the rest); on CPU tensors it runs `convnext_block_plain`,
the kernel's arithmetic in PyTorch (f32 inside, one rounding at the output).

K4 has no backward, in the JAX package or here: the wrapper raises when
autograd records and any input requires a gradient, on either device,
rather than hand back an output that silently cuts the gradient. A caller
that differentiates through a block takes the unfused ops
(`models/codecs/sigmavae._block` does).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

NAME = "convnext_block"
K = 7  # depthwise kernel size (SigmaVAEConfig.kernel)
_P, _I = _build.P, _build.I
_SIGS = {"kt_convnext_block": [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P]}


def convnext_block_plain(x, norm, dw_w, dw_b, up_w, up_b, down_w, down_b,
                         eps: float = 1e-6) -> torch.Tensor:
    """x (B, T, C); norm (C,); dw_w (K, 1, C); dw_b (C,); up_w (1, C, 2H);
    up_b (2H,); down_w (1, H, C); down_b (C,) -> (B, T, C) in x.dtype."""
    t, c = x.shape[1], x.shape[2]
    xf = x.float()
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm.float()
    xp = F.pad(xn, (0, 0, K - 1, 0))  # causal zero rows before t = 0
    dww = dw_w.float().reshape(K, c)
    h = dw_b.float() + sum(xp[:, j: j + t] * dww[j] for j in range(K))
    u = h @ up_w.float()[0] + up_b.float()
    v, g = u.chunk(2, dim=-1)
    a = v * F.gelu(g, approximate="tanh")
    return (xf + a @ down_w.float()[0] + down_b.float()).to(x.dtype)


def convnext_block(x, norm, dw_w, dw_b, up_w, up_b, down_w, down_b,
                   eps: float = 1e-6) -> torch.Tensor:
    """See `convnext_block_plain`."""
    tensors = [x, norm, dw_w, dw_b, up_w, up_b, down_w, down_b]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("convnext_block has no backward: call it under torch.no_grad() "
                           "or with inputs that do not require a gradient")
    if _build.on_cpu(*tensors):
        return convnext_block_plain(x, norm, dw_w, dw_b, up_w, up_b, down_w,
                                    down_b, eps)
    b, t, c = x.shape
    h = down_w.shape[1] if down_w.dim() == 3 else 0
    shapes = ((b, t, c), (c,), (K, 1, c), (c,), (1, c, 2 * h), (2 * h,), (1, h, c), (c,))
    if not (b * t * c * h > 0
            and all(p.shape == s and p.dtype == torch.bfloat16
                    for p, s in zip(tensors, shapes))
            and _build.aligned(*tensors)):
        raise ValueError(
            "convnext_block takes contiguous 32-byte aligned bf16 x (B, T, C), norm "
            "(C,), dw_w (7, 1, C), dw_b (C,), up_w (1, C, 2H), up_b (2H,), down_w "
            "(1, H, C), down_b (C,); got " + _build.describe(*tensors))
    out = torch.empty_like(x)
    lib = _build.load(NAME, _SIGS)
    rc = lib.kt_convnext_block(*(p.data_ptr() for p in tensors), out.data_ptr(),
                               b, t, c, h, eps, _build.stream())
    _build.check(lib, rc, NAME)
    _build.count(NAME)
    return out
