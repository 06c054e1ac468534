"""1-D convolutions and activations for the codecs (port of
kalle_tpu/ops/conv.py).

Same interface as the JAX ops: activations NWC (B, T, C) and kernels
(K, C_in/groups, C_out); a transposed conv's kernel is the JAX one, already
flipped in K. Plain `torch.nn.functional` convolutions, as XLA computes
them in the JAX package. On the card cuDNN takes f32 convolutions in TF32
unless `torch.backends.cudnn.allow_tf32` is False; a caller that compares
f32 results sets it. The weight-import helpers work on numpy arrays, as
the JAX package's do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding=0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """torch conv1d on NWC activations; `padding` is an int (symmetric) or
    (lo, hi) — (k-1, 0) gives a causal conv."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    xc = x.transpose(1, 2)
    if lo != hi:
        xc = F.pad(xc, (lo, hi))
        lo = 0
    y = F.conv1d(xc, w.permute(2, 1, 0), b, stride=stride, padding=lo,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def _torch_transposed(w: torch.Tensor) -> torch.Tensor:
    """The JAX package's transposed-conv kernel (K, C_in, C_out), applied
    there as a cross-correlation over the stride-dilated input -> torch's
    ConvTranspose1d weight (C_in, C_out, K): the same kernel flipped in K."""
    return w.flip(0).permute(1, 2, 0)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch conv_transpose1d on NWC activations: out_len = (T-1)*stride -
    2*padding + K."""
    y = F.conv_transpose1d(x.transpose(1, 2), _torch_transposed(w), b, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def conv_transpose1d_causal(x: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor] = None,
                            stride: int = 1) -> torch.Tensor:
    """conv_transpose1d(padding=0) truncated to exactly T*stride outputs."""
    k = w.shape[0]
    if k < stride:
        raise ValueError(f"conv_transpose1d_causal needs kernel {k} >= stride {stride}")
    t = x.shape[1]
    y = F.conv_transpose1d(x.transpose(1, 2), _torch_transposed(w), b, stride=stride)
    return y[:, :, : t * stride].transpose(1, 2)


def fold_weight_norm(v: np.ndarray, g: np.ndarray, dim_keep: int = 0) -> np.ndarray:
    """torch weight_norm (v, g) -> the dense weight g * v / ||v||, the norm
    over every dim but `dim_keep` (torch's default 0), floored at 1e-12."""
    axes = tuple(i for i in range(v.ndim) if i != dim_keep)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)


def torch_conv_weight(w_oik: np.ndarray) -> np.ndarray:
    """torch Conv1d (O, I, K) -> (K, I, O)."""
    return np.transpose(w_oik, (2, 1, 0))


def torch_conv_transpose_weight(w_iok: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d (I, O, K) -> flipped (K, I, O)."""
    return np.transpose(w_iok[:, :, ::-1], (2, 0, 1))


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               logscale: bool = True) -> torch.Tensor:
    """SnakeBeta: x + 1/(b + 1e-9) * sin(a*x)^2 with per-channel (a, b) on
    the last axis (exp()ed when `logscale`), in f32, cast back to x's dtype."""
    if logscale:
        alpha, beta = alpha.exp(), beta.exp()
    xf = x.float()
    s = torch.sin(xf * alpha)
    return (xf + (1.0 / (beta + 1e-9)) * s * s).to(x.dtype)


def snake(x: torch.Tensor, alpha: torch.Tensor, alpha_logscale: bool = False) -> torch.Tensor:
    """Snake: x + 1/(a + 1e-9) * sin(a*x)^2, in f32, cast back."""
    if alpha_logscale:
        alpha = alpha.exp()
    xf = x.float()
    s = torch.sin(xf * alpha)
    return (xf + (1.0 / (alpha + 1e-9)) * s * s).to(x.dtype)
