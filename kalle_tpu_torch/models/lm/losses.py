"""Distribution heads' losses: closed-form diagonal-Gaussian KL (port of
kalle_tpu/models/lm/losses.py). Per-frame KL is summed over the latent dim
and divided by latent_dim, then averaged over the target / end masks; all
in f32."""
from __future__ import annotations

from typing import Optional

import torch


def gaussian_kl(mean1, std1, mean2, std2) -> torch.Tensor:
    """KL( N(mean1, std1) || N(mean2, std2) ), elementwise, f32."""
    m1, m2, s1, s2 = (x.float() for x in (mean1, mean2, std1, std2))
    return torch.log(s2 / s1) + (s1 * s1 + (m1 - m2) ** 2) / (2.0 * s2 * s2) - 0.5


def gaussian_kl_same_std(mean1, std: float, mean2) -> torch.Tensor:
    """KL with identical stds: (m1 - m2)^2 / (2 std^2) (the sigma head)."""
    d = mean1.float() - mean2.float()
    return d * d / (2.0 * std * std)


def masked_frame_loss(kl_elem: torch.Tensor, latent_dim: int,
                      target_mask: torch.Tensor, end_mask: torch.Tensor,
                      counts: Optional[torch.Tensor] = None):
    """kl_elem (b, t, d) -> (audio_loss, end_loss): per-frame
    kl.sum(-1) / latent_dim, then masked means. counts: the (target, end)
    mask counts of the global batch when this is a rank's share of it
    (the shares then sum to the batch's means); default these masks'."""
    kl = kl_elem.sum(dim=2) / float(latent_dim)
    tm, em = target_mask.float(), end_mask.float()
    c_a, c_e = (tm.sum(), em.sum()) if counts is None else counts
    audio_loss = (kl * tm).sum() / c_a.clamp_min(1.0)
    end_loss = (kl * em).sum() / c_e.clamp_min(1.0)
    return audio_loss, end_loss


def split_mean_scale_btd(x: torch.Tensor):
    """Split a (b, t, 2d) mean||scale stack along the last dim."""
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]
