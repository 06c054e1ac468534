"""ECAPA-TDNN speaker encoder (port of
kalle_tpu/models/conditioning/ecapa.py).

SE-Res2Net TDNN blocks over mel frames, attentive statistics pooling,
then a linear embedding: the speaker conditioning frame of the Llasa
variants (models/lm/variants.py) and the global speaker VAE's input.
BatchNorm runs in its inference form (running statistics), as in the JAX
package: the reference always loads a frozen pretrained encoder. Input
(B, T, n_mels), NWC inside; conv kernels (K, C_in, C_out). cuDNN convs and
cuBLAS matmuls on the card, as XLA computes them in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...bridge import params_from_jax, state_array
from ...ops.conv import conv1d


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    in_channels: int = 80
    channels: int = 512
    embd_dim: int = 2048
    scale: int = 8
    attn_bottleneck: int = 128
    pooled_channels: int = 1536

    @staticmethod
    def tiny() -> "EcapaConfig":
        return EcapaConfig(in_channels=8, channels=16, embd_dim=12, scale=4,
                           attn_bottleneck=8, pooled_channels=24)


def init_params(cfg: EcapaConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params in the JAX package's tree: convs and linears
    uniform(±1/sqrt(fan_in)), BatchNorms the identity (scale 1, shift 0,
    mean 0, var 1)."""
    def u(bound, *shape):
        r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return r * (2 * bound) - bound

    def conv(k, cin, cout, bias=True):
        bound = 1.0 / math.sqrt(cin * k)
        p = {"w": u(bound, k, cin, cout)}
        if bias:
            p["b"] = u(bound, cout)
        return p

    def lin(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return {"w": u(bound, cin, cout), "b": u(bound, cout)}

    def bn(ch):
        return {"scale": torch.ones(ch, device=device), "shift": torch.zeros(ch, device=device),
                "mean": torch.zeros(ch, device=device), "var": torch.ones(ch, device=device)}

    ch, sc = cfg.channels, cfg.scale
    width = ch // sc

    def se_res2():
        return {"conv1": conv(1, ch, ch, bias=False), "bn1": bn(ch),
                "res2_convs": [conv(3, width, width, bias=False) for _ in range(sc - 1)],
                "res2_bns": [bn(width) for _ in range(sc - 1)],
                "conv2": conv(1, ch, ch, bias=False), "bn2": bn(ch),
                "se1": lin(ch, ch // 2), "se2": lin(ch // 2, ch)}

    return {
        "layer1": {"conv": conv(5, cfg.in_channels, ch, bias=False), "bn": bn(ch)},
        "layer2": se_res2(),
        "layer3": se_res2(),
        "layer4": se_res2(),
        "conv": conv(1, 3 * ch, cfg.pooled_channels),
        "attn1": conv(1, cfg.pooled_channels, cfg.attn_bottleneck),
        "attn2": conv(1, cfg.attn_bottleneck, cfg.pooled_channels),
        "bn1": bn(2 * cfg.pooled_channels),
        "linear": lin(2 * cfg.pooled_channels, cfg.embd_dim),
        "bn2": bn(cfg.embd_dim),
    }


def _bn(x, p, eps=1e-5):
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["shift"]


def _se_res2_block(x, p, cfg: EcapaConfig, dilation: int):
    """Conv1dReluBn -> Res2Conv1dReluBn -> Conv1dReluBn -> SE, each conv
    followed by relu then BatchNorm; kernel 3, padding = dilation."""
    sc = cfg.scale
    h = _bn(F.relu(conv1d(x, p["conv1"]["w"])), p["bn1"])
    spx = h.chunk(sc, dim=-1)
    outs, sp = [], None
    for i in range(sc - 1):
        sp = spx[i] if i == 0 else sp + spx[i]
        sp = conv1d(sp, p["res2_convs"][i]["w"], padding=dilation, dilation=dilation)
        sp = _bn(F.relu(sp), p["res2_bns"][i])
        outs.append(sp)
    outs.append(spx[sc - 1])
    h = _bn(F.relu(conv1d(torch.cat(outs, dim=-1), p["conv2"]["w"])), p["bn2"])
    s = F.relu(h.mean(dim=1) @ p["se1"]["w"] + p["se1"]["b"])
    s = torch.sigmoid(s @ p["se2"]["w"] + p["se2"]["b"])
    return h * s[:, None, :]


def forward(params: dict, cfg: EcapaConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> embedding (B, embd_dim)."""
    p = params
    out1 = _bn(F.relu(conv1d(mel, p["layer1"]["conv"]["w"], padding=2)), p["layer1"]["bn"])
    out2 = _se_res2_block(out1, p["layer2"], cfg, 2) + out1
    out3 = _se_res2_block(out1 + out2, p["layer3"], cfg, 3) + out1 + out2
    out4 = _se_res2_block(out1 + out2 + out3, p["layer4"], cfg, 4) + out1 + out2 + out3

    h = F.relu(conv1d(torch.cat([out2, out3, out4], dim=-1), p["conv"]["w"], p["conv"]["b"]))
    # attentive statistics pooling over time
    a = torch.tanh(conv1d(h, p["attn1"]["w"], p["attn1"]["b"]))
    a = torch.softmax(conv1d(a, p["attn2"]["w"], p["attn2"]["b"]), dim=1)
    mean = (a * h).sum(dim=1)
    var = (a * h * h).sum(dim=1) - mean * mean
    pooled = torch.cat([mean, torch.sqrt(var.clamp_min(1e-9))], dim=-1)
    h = _bn(pooled, p["bn1"]) @ p["linear"]["w"] + p["linear"]["b"]
    return _bn(h, p["bn2"])


def params_from_state_dict(sd: Dict[str, Any], cfg: EcapaConfig, device="cuda") -> dict:
    """A torch ECAPA_TDNN state dict (the reference's naming; torch tensors
    or numpy arrays) -> this module's f32 tree on `device`."""
    a = lambda name: state_array(sd[name])

    def conv(prefix, bias=True):
        out = {"w": np.transpose(a(prefix + ".weight"), (2, 1, 0))}
        if bias and prefix + ".bias" in sd:
            out["b"] = a(prefix + ".bias")
        return out

    def bn(prefix):
        return {"scale": a(prefix + ".weight"), "shift": a(prefix + ".bias"),
                "mean": a(prefix + ".running_mean"), "var": a(prefix + ".running_var")}

    def lin(prefix):
        return {"w": a(prefix + ".weight").T, "b": a(prefix + ".bias")}

    def se_res2(base):
        n = cfg.scale - 1
        return {"conv1": conv(f"{base}.0.conv", bias=False), "bn1": bn(f"{base}.0.bn"),
                "res2_convs": [conv(f"{base}.1.convs.{i}", bias=False) for i in range(n)],
                "res2_bns": [bn(f"{base}.1.bns.{i}") for i in range(n)],
                "conv2": conv(f"{base}.2.conv", bias=False), "bn2": bn(f"{base}.2.bn"),
                "se1": lin(f"{base}.3.linear1"), "se2": lin(f"{base}.3.linear2")}

    tree = {
        "layer1": {"conv": conv("layer1.conv", bias=False), "bn": bn("layer1.bn")},
        "layer2": se_res2("layer2"),
        "layer3": se_res2("layer3"),
        "layer4": se_res2("layer4"),
        "conv": conv("conv"),
        "attn1": conv("pooling.linear1"),
        "attn2": conv("pooling.linear2"),
        "bn1": bn("bn1"),
        "linear": lin("linear"),
        "bn2": bn("bn2"),
    }
    return params_from_jax(tree, device=device)
