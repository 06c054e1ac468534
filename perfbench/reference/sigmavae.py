"""The plain reference of the SigmaVAE decoder (24 kHz, 64-d latents at
7.5 Hz): a pointwise input conv; per stage two ConvNeXt residual blocks
(RMSNorm, causal depthwise conv k=7, GEGLU MLP with tanh GELU, residual)
and a causal transposed-conv upsampler; then RMSNorm, a causal conv and
tanh. float32 PyTorch, written from the architecture; imports nothing of
the program. Activations are (B, T, C) and kernels (K, C_in/groups,
C_out), the layout `perfbench.weights.codec_params` draws them in.

precision "fp8" rounds every convolution's operands to float8 e4m3 with a
per-tensor scale (the control of the bf16 codec the configuration serves).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .llasa import fp8_round


class Decoder:
    def __init__(self, params: dict, cfg: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.p = params["decoder"]
        self.cfg = cfg
        self.hop = math.prod(cfg["strides"])
        self.q = fp8_round if precision == "fp8" else (lambda t: t)

    def conv(self, x, w, b, stride=1, left=0, groups=1):
        """Causal conv on (B, T, C): `left` zeros padded in front."""
        xc = F.pad(self.q(x).transpose(1, 2), (left, 0))
        y = F.conv1d(xc, self.q(w.float()).permute(2, 1, 0), b.float(), stride=stride,
                     groups=groups)
        return y.transpose(1, 2)

    def up(self, x, w, b, stride):
        """Causal transposed conv: exactly T * stride outputs. The kernel is
        applied as a cross-correlation over the stride-dilated input, so
        torch's ConvTranspose1d takes it flipped in K."""
        t = x.shape[1]
        wt = self.q(w.float()).flip(0).permute(1, 2, 0)
        y = F.conv_transpose1d(self.q(x).transpose(1, 2), wt, b.float(), stride=stride)
        return y[:, :, :t * stride].transpose(1, 2)

    @staticmethod
    def rms(x, scale, eps=1e-6):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()

    def block(self, x, p):
        k = self.cfg["kernel"]
        h = self.rms(x, p["norm"])
        h = self.conv(h, p["dw"]["w"], p["dw"]["b"], left=k - 1, groups=x.shape[-1])
        h = self.conv(h, p["up"]["w"], p["up"]["b"])
        v, g = h.chunk(2, dim=-1)
        h = v * F.gelu(g, approximate="tanh")
        return x + self.conv(h, p["down"]["w"], p["down"]["b"])

    @torch.no_grad()
    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, T, d) -> audio (B, T * hop) in [-1, 1]."""
        p = self.p
        x = self.conv(z.float(), p["pre"]["w"], p["pre"]["b"])
        for st, s in zip(p["stages"], reversed(self.cfg["strides"])):
            for blk in st["blocks"]:
                x = self.block(x, blk)
            x = self.up(x, st["up"]["w"], st["up"]["b"], s)
        x = self.rms(x, p["post_norm"])
        x = self.conv(x, p["post"]["w"], p["post"]["b"], left=self.cfg["kernel"] - 1)
        return torch.tanh(x)[..., 0]
