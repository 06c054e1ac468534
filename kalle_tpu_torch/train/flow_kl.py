"""Flow-space KL auxiliary loss for LM training (port of
kalle_tpu/train/flow_kl.py).

Latents are drawn from the predicted and the label distributions, pushed
through the frozen mel-VAE residual-coupling flow (`melvae.flow`, no
gradient), and the KL between the flow-space distributions is
masked-meaned. The gradient reaches `pre_mean` and `pre_log_scale` through
the predicted stds, none the flow's parameters.

The reference draws the reparameterisation noise with `rand_like`
(uniform); the default here is normal noise, `uniform_noise=True` gives
the reference's. Draws: the prediction's (b, t, d), then the label's, from
`generator`; `noise=(n_pred, n_label)` injects them (the JAX package
splits its key in two, in that order).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.codecs import melvae
from ..models.lm.losses import gaussian_kl, split_mean_scale_btd


def flow_space_kl(flow_params: dict, flow_cfg: melvae.MelVAEConfig,
                  outputs: Dict[str, torch.Tensor],  # pre_mean, pre_log_scale (b, t, d)
                  labels: torch.Tensor,              # distribute_labels (b, t, 2d)
                  target_mask: torch.Tensor,         # (b, t)
                  generator: Optional[torch.Generator] = None,
                  uniform_noise: bool = False,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    mean, logs = outputs["pre_mean"], outputs["pre_log_scale"]
    mean_l, logs_l = split_mean_scale_btd(labels)
    if noise is None:
        draw = torch.rand if uniform_noise else torch.randn
        noise = tuple(draw(m.shape, generator=generator, device=m.device, dtype=m.dtype)
                      for m in (mean, mean_l))
    lat_p = mean + torch.exp(logs) * noise[0].to(mean.device, mean.dtype)
    lat_l = mean_l + torch.exp(logs_l) * noise[1].to(mean_l.device, mean_l.dtype)
    z_p = melvae.flow(flow_params, flow_cfg, lat_p.transpose(1, 2)).transpose(1, 2)
    z_l = melvae.flow(flow_params, flow_cfg, lat_l.transpose(1, 2)).transpose(1, 2)
    kl = gaussian_kl(z_p, torch.exp(logs), z_l, torch.exp(logs_l))
    kl = kl.sum(2) / mean.shape[-1]
    tm = target_mask.float()
    return (kl * tm).sum() / tm.sum().clamp_min(1.0)
