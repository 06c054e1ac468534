"""MRTE, the multi-reference timbre encoder (port of
kalle_tpu/models/conditioning/mrte.py).

Residual conv stacks over mel frames with a strided middle conv, then a
cross-attention of phone embeddings over that mel context. Returns the
global mel conditioning and the per-phone conditioning. Inference form
(dropout off). mel (B, mel_bins, T) channel-first at the boundary, NWC
inside; phone_x (B, T_p, hidden). cuDNN convs and cuBLAS matmuls on the
card, as XLA computes them in the JAX package.
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
class MRTEConfig:
    mel_bins: int = 80
    hidden_size: int = 2048
    kernel_size: int = 3
    mel_stride: int = 16
    n_layers: int = 5
    n_stacks: int = 5
    n_blocks: int = 2
    n_heads: int = 1
    activation: str = "relu"

    @staticmethod
    def tiny() -> "MRTEConfig":
        return MRTEConfig(mel_bins=8, hidden_size=16, mel_stride=4, n_layers=2, n_stacks=2,
                          n_blocks=1)


def init_params(cfg: MRTEConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params in the JAX package's tree: convs and linears
    uniform(±1/sqrt(fan_in)), LayerNorms the identity."""
    def u(bound, *shape):
        r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return r * (2 * bound) - bound

    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(cin * k)
        return {"w": u(bound, k, cin, cout), "b": u(bound, cout)}

    def lin(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return {"w": u(bound, cin, cout), "b": u(bound, cout)}

    h = cfg.hidden_size
    ln = lambda: {"scale": torch.ones(h, device=device), "shift": torch.zeros(h, device=device)}

    def res_stack():
        return [[{"conv": conv(cfg.kernel_size, h, h), "norm": ln()}
                 for _ in range(cfg.n_blocks)] for _ in range(cfg.n_stacks)]

    return {
        "first": conv(cfg.kernel_size, cfg.mel_bins, h),
        "middle": conv(cfg.mel_stride + 1, h, h),
        "layers": [{"stack1": res_stack(), "stack2": res_stack()} for _ in range(cfg.n_layers)],
        "last": conv(cfg.kernel_size, h, h),
        "wq": lin(h, h),
        "wk": lin(h, h),
        "wv": lin(h, h),
        "out_proj": lin(h, h),
        "norm": ln(),
        "adapter_cond_emb": lin(h, 2048),
    }


def _ln(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["shift"]


def _res_stack(x, stack, cfg: MRTEConfig):
    """Each stack: x + (activation -> conv -> LayerNorm) over its blocks."""
    act = F.relu if cfg.activation == "relu" else (lambda y: F.gelu(y, approximate="tanh"))
    for blocks in stack:
        h = x
        for b in blocks:
            h = _ln(conv1d(act(h), b["conv"]["w"], b["conv"]["b"],
                           padding=(cfg.kernel_size - 1) // 2), b["norm"])
        x = x + h
    return x


def _mel_encoder(p, cfg: MRTEConfig, mel_nwc):
    pad = (cfg.kernel_size - 1) // 2
    x = conv1d(mel_nwc, p["first"]["w"], p["first"]["b"], padding=pad)
    outs = None
    for layer in p["layers"]:
        h = _res_stack(x, layer["stack1"], cfg)
        h = conv1d(h, p["middle"]["w"], p["middle"]["b"], stride=cfg.mel_stride,
                   padding=cfg.mel_stride // 2)
        h = _res_stack(h, layer["stack2"], cfg)
        outs = h if outs is None else outs + h
    return conv1d(outs, p["last"]["w"], p["last"]["b"], padding=pad)


def forward(params: dict, cfg: MRTEConfig, mel: torch.Tensor, phone_x: torch.Tensor):
    """mel (B, mel_bins, T), phone_x (B, T_p, hidden) ->
    (mel_cond (B, 2048), tc_latent (B, T_p, hidden))."""
    p = params
    mel_ctx = _mel_encoder(p, cfg, mel.transpose(1, 2))  # (B, T', h)
    q = phone_x @ p["wq"]["w"] + p["wq"]["b"]
    k = mel_ctx @ p["wk"]["w"] + p["wk"]["b"]
    v = mel_ctx @ p["wv"]["w"] + p["wv"]["b"]
    b, tq, h = q.shape
    nh = cfg.n_heads
    hd = h // nh
    q, k, v = (t.reshape(b, t.shape[1], nh, hd) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    att = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att.to(v.dtype), v).reshape(b, tq, h)
    tc = F.relu(_ln(o @ p["out_proj"]["w"] + p["out_proj"]["b"], p["norm"]))
    mel_cond = mel_ctx.mean(dim=1) @ p["adapter_cond_emb"]["w"] + p["adapter_cond_emb"]["b"]
    return mel_cond, tc


def params_from_state_dict(sd: Dict[str, Any], cfg: MRTEConfig, device="cuda") -> dict:
    """A torch MRTE state dict (the reference's naming; torch tensors or
    numpy arrays) -> this module's f32 tree on `device`."""
    a = lambda name: state_array(sd[name])

    def conv(prefix):
        return {"w": np.transpose(a(prefix + ".weight"), (2, 1, 0)), "b": a(prefix + ".bias")}

    def lin(prefix):
        return {"w": a(prefix + ".weight").T, "b": a(prefix + ".bias")}

    def ln(prefix):
        return {"scale": a(prefix + ".weight"), "shift": a(prefix + ".bias")}

    def stack(base, which):
        return [[{"conv": conv(f"{base}.{which}.conv_stacks.{s}.blocks.{b}.conv"),
                  "norm": ln(f"{base}.{which}.conv_stacks.{s}.blocks.{b}.norm")}
                 for b in range(cfg.n_blocks)] for s in range(cfg.n_stacks)]

    layers = [{"stack1": stack(f"mel_encoder.layers.{i}", "conv_stack1"),
               "stack2": stack(f"mel_encoder.layers.{i}", "conv_stack2")}
              for i in range(cfg.n_layers)]
    tree = {
        "first": conv("mel_encoder.first_layer"),
        "middle": conv("mel_encoder_middle_layer"),
        "layers": layers,
        "last": conv("mel_encoder.last_layer"),
        "wq": lin("mha.w_q"),
        "wk": lin("mha.w_k"),
        "wv": lin("mha.w_v"),
        "out_proj": lin("mha.out_proj.0"),
        "norm": ln("norm"),
        "adapter_cond_emb": lin("adapter_cond_emb"),
    }
    return params_from_jax(tree, device=device)
