"""SigmaVAE acoustic codec, decoder path (port of
kalle_tpu/models/codecs/sigmavae.py:46-238).

24 kHz mono, 64-dim latents at 7.5 Hz (strides 4*4*5*5*8 = 3200). The
decoder is a pointwise input conv, then per stage ConvNeXt residual blocks
(RMSNorm -> causal depthwise conv k=7 -> GEGLU MLP -> residual) and a
causal transposed conv upsampler, then RMSNorm, a causal conv and tanh.
Activations are NWC (B, T, C) and conv kernels (K, C_in/groups, C_out), as
in the JAX package.

A residual block in bf16 on the card runs the fused kernel K4
(ops/kernels/convnext_block.py), as the JAX package sends bf16 blocks off
the CPU to its Pallas kernel; any other block runs the plain ops.
`encode` and the `gemm_blocks` formulation are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d, conv_transpose1d_causal
from ...ops.kernels.convnext_block import convnext_block


@dataclasses.dataclass(frozen=True)
class SigmaVAEConfig:
    latent_dim: int = 64
    sample_rate: int = 24000
    strides: Tuple[int, ...] = (4, 4, 5, 5, 8)   # product = 3200 -> 7.5 Hz
    channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    blocks_per_stage: int = 2
    mlp_ratio: int = 2
    kernel: int = 7
    sigma: float = 0.5
    # route bf16 residual blocks on the card through the fused kernel K4
    fused_blocks: bool = True

    @property
    def hop(self) -> int:
        return int(np.prod(self.strides))

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop

    @staticmethod
    def tiny() -> "SigmaVAEConfig":
        return SigmaVAEConfig(latent_dim=8, strides=(2, 4),
                              channels=(4, 8), blocks_per_stage=1)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def init_params(cfg: SigmaVAEConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random init in f32: conv weights and biases uniform(±1/sqrt(fan_in)),
    norm scales ones. Same tree and layouts as the JAX package."""
    def conv(k, cin, cout, groups=1):
        bound = 1.0 / math.sqrt((cin // groups) * k)

        def u(*shape):
            r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return r * (2 * bound) - bound

        return {"w": u(k, cin // groups, cout), "b": u(cout)}

    def block(ch):
        hid = cfg.mlp_ratio * ch
        return {"norm": torch.ones(ch, device=device),
                "dw": conv(cfg.kernel, ch, ch, groups=ch),
                "up": conv(1, ch, 2 * hid),   # GEGLU: value + gate
                "down": conv(1, hid, ch)}

    chs = cfg.channels
    enc: Dict[str, Any] = {"pre": conv(cfg.kernel, 1, chs[0]), "stages": []}
    for i, s in enumerate(cfg.strides):
        cout = chs[i + 1] if i + 1 < len(chs) else chs[-1]
        enc["stages"].append({"down": conv(2 * s, chs[i], cout),
                              "blocks": [block(cout) for _ in range(cfg.blocks_per_stage)]})
    enc["head"] = conv(1, chs[-1], cfg.latent_dim)

    dec: Dict[str, Any] = {"pre": conv(1, cfg.latent_dim, chs[-1]), "stages": []}
    for i in reversed(range(len(cfg.strides))):
        cin = chs[i + 1] if i + 1 < len(chs) else chs[-1]
        dec["stages"].append({"blocks": [block(cin) for _ in range(cfg.blocks_per_stage)],
                              "up": conv(2 * cfg.strides[i], cin, chs[i])})
    dec["post_norm"] = torch.ones(chs[0], device=device)
    dec["post"] = conv(cfg.kernel, chs[0], 1)
    return {"encoder": enc, "decoder": dec}


def _block(x: torch.Tensor, p: dict, cfg: SigmaVAEConfig) -> torch.Tensor:
    if (cfg.fused_blocks and cfg.kernel == 7 and x.dtype == torch.bfloat16
            and x.is_cuda):
        # the convs hand back NWC views of NCW tensors; K4 reads (B, T, C) rows
        return convnext_block(x.contiguous(), p["norm"], p["dw"]["w"], p["dw"]["b"],
                              p["up"]["w"], p["up"]["b"], p["down"]["w"],
                              p["down"]["b"])
    h = _rms_norm(x, p["norm"])
    h = conv1d(h, p["dw"]["w"], p["dw"]["b"], groups=x.shape[-1],
               padding=(cfg.kernel - 1, 0))  # causal depthwise
    h = h @ p["up"]["w"][0] + p["up"]["b"]
    v, g = h.chunk(2, dim=-1)
    h = v * F.gelu(g, approximate="tanh")
    return x + (h @ p["down"]["w"][0] + p["down"]["b"])


def _decode_nwc(params: dict, cfg: SigmaVAEConfig, z: torch.Tensor) -> torch.Tensor:
    p = params["decoder"]
    x = conv1d(z, p["pre"]["w"], p["pre"]["b"])
    for st, s in zip(p["stages"], reversed(cfg.strides)):
        for blk in st["blocks"]:
            x = _block(x, blk, cfg)
        x = conv_transpose1d_causal(x, st["up"]["w"], st["up"]["b"], stride=s)
    x = _rms_norm(x, p["post_norm"])
    x = conv1d(x, p["post"]["w"], p["post"]["b"], padding=(cfg.kernel - 1, 0))
    return torch.tanh(x)


def _orient_btd(latents: torch.Tensor, d: int) -> torch.Tensor:
    """Accept (B, T, d) or (B, d, T); return (B, T, d). An ambiguous square
    (T == d) is read as (B, d, T), as in the JAX package."""
    if latents.shape[1] == d:
        return latents.transpose(1, 2)
    return latents


@torch.no_grad()
def decode(params: dict, cfg: SigmaVAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, T, d) or (B, d, T) -> wav (B, 1, T * hop) at 24 kHz."""
    z = _orient_btd(latents, cfg.latent_dim)
    return _decode_nwc(params, cfg, z).transpose(1, 2)
