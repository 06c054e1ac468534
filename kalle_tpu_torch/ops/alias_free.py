"""Anti-aliased activation: 2x kaiser-sinc upsample -> pointwise
nonlinearity -> 2x downsample (port of kalle_tpu/ops/alias_free.py; the
BigVGAN Activation1d the mel-VAE decoder runs around every conv).

NWC activations (B, T, C). Both resamplers edge-pad and run a depthwise
(groups = C) conv over the 12-tap filter: a transposed conv for the
upsampler, a strided conv for the downsampler. cuDNN on the card, as XLA
computes them in the JAX package: no Pallas kernel takes them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """The kaiser-windowed sinc low-pass (kernel_size,), summing to 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    f = f / f.sum()
    return f.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _up_filter(ratio: int, kernel_size: int) -> np.ndarray:
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)


def _depthwise_filter(x: torch.Tensor, ratio: int, kernel_size: int) -> torch.Tensor:
    """The filter as a depthwise weight (C, 1, K) on x's device and dtype."""
    filt = torch.from_numpy(_up_filter(ratio, kernel_size)).to(x.device, x.dtype)
    return filt.expand(x.shape[-1], 1, kernel_size)


def upsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """x (B, T, C) -> (B, T*ratio, C)."""
    kernel_size = int(6 * ratio // 2) * 2
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    xc = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    # the JAX package correlates the reversed filter over the dilated
    # input: torch's transposed conv takes the filter as it is
    y = F.conv_transpose1d(xc, _depthwise_filter(x, ratio, kernel_size), stride=ratio,
                           groups=x.shape[-1]) * ratio
    return y[:, :, pad_left:y.shape[-1] - pad_right].transpose(1, 2)


def downsample1d(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """x (B, T, C) -> (B, T // ratio, C): the low-pass with stride."""
    kernel_size = int(6 * ratio // 2) * 2
    pad_left = kernel_size // 2 - int(kernel_size % 2 == 0)
    pad_right = kernel_size // 2
    xc = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    y = F.conv1d(xc, _depthwise_filter(x, ratio, kernel_size), stride=ratio,
                 groups=x.shape[-1])
    return y.transpose(1, 2)


def alias_free_act(x: torch.Tensor, act_fn, up_ratio: int = 2,
                   down_ratio: int = 2) -> torch.Tensor:
    """Activation1d: upsample -> act -> downsample."""
    return downsample1d(act_fn(upsample1d(x, up_ratio)), down_ratio)
