"""Codec training losses (port of kalle_tpu/train/codec_losses.py):
multi-resolution STFT, the stereo sum-and-difference STFT, L1, KL, and the
least-squares and hinge adversarial losses with feature matching.

The JAX package's quirks are kept: `multi_resolution_stft_loss` divides by
the number of resolutions even when one longer than the signal is
skipped; `sum_and_difference_stft_loss` counts the sd-STFT twice
(`w_sd=2.0`, as the reference wrapper appends that loss twice); the hinge
generator loss is summed over the scales, not meaned. Plain PyTorch on
`ops.mel.stft_mag`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.mel import stft_mag

# auraloss defaults (fft_sizes, hop_sizes, win_lengths)
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
              win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral_convergence, log_magnitude_L1) for (..., T) signals."""
    sx = stft_mag(x, n_fft, hop, win, power=1.0)
    sy = stft_mag(y, n_fft, hop, win, power=1.0)
    sc = torch.linalg.vector_norm(sy - sx) / torch.linalg.vector_norm(sy).clamp_min(1e-8)
    mag = (torch.log(sx + 1e-7) - torch.log(sy + 1e-7)).abs().mean()
    return sc, mag


def multi_resolution_stft_loss(
    x: torch.Tensor, y: torch.Tensor,
    resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS,
    w_sc: float = 1.0, w_mag: float = 1.0,
) -> torch.Tensor:
    """x = reconstruction, y = target; signals (..., T)."""
    total = x.new_zeros(())
    for n_fft, hop, win in resolutions:
        if y.shape[-1] < n_fft:
            continue
        sc, mag = stft_loss(x, y, n_fft, hop, win)
        total = total + w_sc * sc + w_mag * mag
    return total / len(resolutions)


def sum_and_difference_stft_loss(
    x: torch.Tensor, y: torch.Tensor,
    resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS,
    w_sd: float = 2.0, w_lr: float = 0.5,
) -> torch.Tensor:
    """Stereo mid/side MRSTFT, x = reconstruction, y = target, both
    (B, 2, T): w_sd * (MRSTFT(L+R) + MRSTFT(L-R)) / 2 + w_lr * (MRSTFT(L)
    + MRSTFT(R))."""
    sum_x, diff_x = x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]
    sum_y, diff_y = y[:, 0] + y[:, 1], y[:, 0] - y[:, 1]
    sd = (multi_resolution_stft_loss(sum_x, sum_y, resolutions)
          + multi_resolution_stft_loss(diff_x, diff_y, resolutions)) / 2.0
    lr = (multi_resolution_stft_loss(x[:, 0], y[:, 0], resolutions)
          + multi_resolution_stft_loss(x[:, 1], y[:, 1], resolutions))
    return w_sd * sd + w_lr * lr


def l1_time_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def vae_kl_loss(mean: torch.Tensor, logs: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, exp(logs)) || N(0, 1)) per element, meaned."""
    var = torch.exp(2.0 * logs)
    return (0.5 * (mean * mean + var - 2.0 * logs - 1.0)).mean()


# ---- adversarial (least-squares GAN, Encodec/BigVGAN convention) ----

def generator_adv_loss(fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(((1.0 - f) ** 2).mean() for f in fake_logits) / len(fake_logits)


def discriminator_adv_loss(real_logits: Sequence[torch.Tensor],
                           fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + ((1.0 - r) ** 2).mean() + (f ** 2).mean()
    return loss / len(real_logits)


def generator_hinge_loss(fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """Summed over the scales, not meaned (as the reference's Encodec-family
    hinge loss accumulates them)."""
    return sum(-f.mean() for f in fake_logits)


def discriminator_hinge_loss(real_logits: Sequence[torch.Tensor],
                             fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
    return loss


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    """L1 over all intermediate discriminator features, meaned over them."""
    total = 0.0
    n = 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            total = total + (r - f).abs().mean()
            n += 1
    return total / max(n, 1)
