"""1-D convolutions for the codec (port of kalle_tpu/ops/conv.py:24-107).

Same interface as the JAX ops: activations NWC (B, T, C) and kernels
(K, C_in/groups, C_out). Plain `torch.nn.functional` convolutions, as XLA
computes them in the JAX package. On the card cuDNN takes f32 convolutions
in TF32 unless `torch.backends.cudnn.allow_tf32` is False; a caller that
compares f32 results sets it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding=0, groups: int = 1) -> torch.Tensor:
    """torch conv1d on NWC activations; `padding` is an int (symmetric) or
    (lo, hi) — (k-1, 0) gives a causal conv."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    xc = x.transpose(1, 2)
    if lo != hi:
        xc = F.pad(xc, (lo, hi))
        lo = 0
    y = F.conv1d(xc, w.permute(2, 1, 0), b, stride=stride, padding=lo, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d_causal(x: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor] = None,
                            stride: int = 1) -> torch.Tensor:
    """conv_transpose1d(padding=0) truncated to exactly T*stride outputs.

    `w` (K, C_in, C_out) is the JAX package's kernel, applied there as a
    cross-correlation over the stride-dilated input; torch's
    ConvTranspose1d weight (C_in, C_out, K) is that kernel flipped in K."""
    k = w.shape[0]
    if k < stride:
        raise ValueError(f"conv_transpose1d_causal needs kernel {k} >= stride {stride}")
    t = x.shape[1]
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), b,
                           stride=stride)
    return y[:, :, : t * stride].transpose(1, 2)
