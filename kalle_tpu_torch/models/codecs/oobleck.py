"""Oobleck VAE, the stable-audio-open autoencoder (port of
kalle_tpu/models/codecs/oobleck.py).

As in the JAX package (and kalle-audio's passthrough bottleneck), `encode`
returns the raw (B, 2d, T/ratio) mean||scale stack and leaves sampling to
the caller; `decode` takes (B, d, T') latents and returns tanh-clipped
(B, 2, T'*ratio) audio. External tensors are channel-first; inside,
activations are NWC (B, T, C) and conv kernels (K, C_in, C_out), the JAX
package's tree and layouts. Weight norm is folded at import. The convs are
cuDNN on the card and the SnakeBeta activations plain torch in f32, as XLA
computes them in the JAX package: no Pallas kernel takes this codec.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...bridge import params_from_jax, state_array
from ...ops.conv import (conv1d, conv_transpose1d, fold_weight_norm, snake_beta,
                         torch_conv_transpose_weight, torch_conv_weight)


@dataclasses.dataclass(frozen=True)
class OobleckConfig:
    """The stable-audio-open-1.0 operating point by default."""

    io_channels: int = 2
    channels: int = 128
    latent_dim: int = 64           # decoder input dim
    encoder_out_dim: int = 128     # 2 * latent (mean||scale)
    c_mults: Tuple[int, ...] = (1, 2, 4, 8, 16)
    strides: Tuple[int, ...] = (2, 4, 4, 8, 8)
    use_snake: bool = True
    final_tanh: bool = True
    sample_rate: int = 44100
    scale: float = 1.0  # AutoencoderPretransform's scale

    @property
    def downsampling_ratio(self) -> int:
        return int(np.prod(self.strides))

    @staticmethod
    def from_model_config(cfg: Dict[str, Any]) -> "OobleckConfig":
        """Parse a stable_audio_tools model_config.json: a top-level
        autoencoder, or the `pretransform` of a diffusion model (SAO-1.0's
        layout)."""
        scale = 1.0
        if cfg.get("model_type") == "autoencoder":
            ae = cfg["model"]
        elif "pretransform" in cfg.get("model", {}):
            pre = cfg["model"]["pretransform"]
            scale = pre.get("scale", 1.0)
            ae = pre["config"]
        else:
            raise ValueError("no autoencoder config found")
        enc = ae["encoder"]["config"]
        dec = ae["decoder"]["config"]
        return OobleckConfig(
            io_channels=ae.get("io_channels", 2),
            channels=enc.get("channels", 128),
            latent_dim=dec.get("latent_dim", ae.get("latent_dim", 64)),
            encoder_out_dim=enc.get("latent_dim", 128),
            c_mults=tuple(enc.get("c_mults", (1, 2, 4, 8, 16))),
            strides=tuple(enc.get("strides", (2, 4, 4, 8, 8))),
            use_snake=enc.get("use_snake", True),
            final_tanh=dec.get("final_tanh", True),
            sample_rate=cfg.get("sample_rate", 44100),
            scale=scale,
        )


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

def _uniform(generator, device, bound, *shape):
    r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return r * (2 * bound) - bound


def _conv_init(generator, device, k, cin, cout, bias=True):
    bound = 1.0 / math.sqrt(cin * k)
    p = {"w": _uniform(generator, device, bound, k, cin, cout)}
    if bias:
        p["b"] = _uniform(generator, device, bound, cout)
    return p


def _act_init(ch, use_snake, device):
    if use_snake:
        return {"alpha": torch.zeros(ch, device=device), "beta": torch.zeros(ch, device=device)}
    return {}


def init_params(cfg: OobleckConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params (convs uniform(±1/sqrt(fan_in)), snake params 0):
    the JAX package's tree."""
    c_mults = (1,) + tuple(cfg.c_mults)
    ch = cfg.channels
    conv = lambda *a, **kw: _conv_init(generator, device, *a, **kw)
    act = lambda c: _act_init(c, cfg.use_snake, device)

    def res_unit(c):
        return {"act1": act(c), "conv1": conv(7, c, c), "act2": act(c), "conv2": conv(1, c, c)}

    enc: Dict[str, Any] = {"in_conv": conv(7, cfg.io_channels, c_mults[0] * ch), "blocks": []}
    for i in range(len(c_mults) - 1):
        cin, cout, s = c_mults[i] * ch, c_mults[i + 1] * ch, cfg.strides[i]
        enc["blocks"].append({"res": [res_unit(cin) for _ in range(3)], "act": act(cin),
                              "down": conv(2 * s, cin, cout)})
    enc["out_act"] = act(c_mults[-1] * ch)
    enc["out_conv"] = conv(3, c_mults[-1] * ch, cfg.encoder_out_dim)

    dec: Dict[str, Any] = {"in_conv": conv(7, cfg.latent_dim, c_mults[-1] * ch), "blocks": []}
    for i in range(len(c_mults) - 1, 0, -1):
        cin, cout, s = c_mults[i] * ch, c_mults[i - 1] * ch, cfg.strides[i - 1]
        dec["blocks"].append({"act": act(cin), "up": conv(2 * s + s % 2, cin, cout),
                              "res": [res_unit(cout) for _ in range(3)]})
    dec["out_act"] = act(c_mults[0] * ch)
    dec["out_conv"] = conv(7, c_mults[0] * ch, cfg.io_channels, bias=False)  # no bias
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# Forward (NWC inside)
# ---------------------------------------------------------------------------

def _act(x, p, use_snake):
    return snake_beta(x, p["alpha"], p["beta"]) if use_snake else F.elu(x)


def _res_unit(x, p, dilation, use_snake):
    h = _act(x, p["act1"], use_snake)
    h = conv1d(h, p["conv1"]["w"], p["conv1"]["b"], padding=3 * dilation, dilation=dilation)
    h = _act(h, p["act2"], use_snake)
    return conv1d(h, p["conv2"]["w"], p["conv2"]["b"]) + x


def encode_nwc(params: dict, cfg: OobleckConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, io_ch) -> (B, T/ratio, 2*latent) mean||scale."""
    p = params["encoder"]
    x = conv1d(x, p["in_conv"]["w"], p["in_conv"]["b"], padding=3)
    for blk, s in zip(p["blocks"], cfg.strides):
        for res, d in zip(blk["res"], (1, 3, 9)):
            x = _res_unit(x, res, d, cfg.use_snake)
        x = _act(x, blk["act"], cfg.use_snake)
        x = conv1d(x, blk["down"]["w"], blk["down"]["b"], stride=s, padding=math.ceil(s / 2))
    x = _act(x, p["out_act"], cfg.use_snake)
    return conv1d(x, p["out_conv"]["w"], p["out_conv"]["b"], padding=1)


def decode_nwc(params: dict, cfg: OobleckConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, T', latent) -> (B, T'*ratio, io_ch)."""
    p = params["decoder"]
    x = conv1d(z, p["in_conv"]["w"], p["in_conv"]["b"], padding=3)
    for blk, s in zip(p["blocks"], reversed(cfg.strides)):
        x = _act(x, blk["act"], cfg.use_snake)
        x = conv_transpose1d(x, blk["up"]["w"], blk["up"]["b"], stride=s,
                             padding=math.ceil(s / 2))
        for res, d in zip(blk["res"], (1, 3, 9)):
            x = _res_unit(x, res, d, cfg.use_snake)
    x = _act(x, p["out_act"], cfg.use_snake)
    x = conv1d(x, p["out_conv"]["w"], None, padding=3)
    return torch.tanh(x) if cfg.final_tanh else x


@torch.no_grad()
def encode(params: dict, cfg: OobleckConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, io_ch, T) -> (B, 2*latent, T/ratio) / scale."""
    return encode_nwc(params, cfg, audio.transpose(1, 2)).transpose(1, 2) / cfg.scale


@torch.no_grad()
def decode(params: dict, cfg: OobleckConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, latent, T') * scale -> audio (B, io_ch, T'*ratio)."""
    return decode_nwc(params, cfg, latents.transpose(1, 2) * cfg.scale).transpose(1, 2)


# ---------------------------------------------------------------------------
# torch checkpoint import (numpy, as the JAX package's; moved to the device
# at the end)
# ---------------------------------------------------------------------------

def _dense_weight(sd, prefix) -> np.ndarray:
    """A conv's weight, weight norm folded: old-style weight_v / weight_g,
    parametrizations' original1 / original0, or a plain weight."""
    if prefix + ".weight_v" in sd:
        return fold_weight_norm(state_array(sd[prefix + ".weight_v"]), state_array(sd[prefix + ".weight_g"]))
    if prefix + ".parametrizations.weight.original1" in sd:
        return fold_weight_norm(state_array(sd[prefix + ".parametrizations.weight.original1"]),
                                state_array(sd[prefix + ".parametrizations.weight.original0"]))
    return state_array(sd[prefix + ".weight"])


def _import_conv(sd, prefix, transposed=False) -> dict:
    # torch weight_norm keeps dim 0 for a ConvTranspose1d too: its INPUT
    # channels, of its (I, O, K) weight
    w = _dense_weight(sd, prefix)
    out = {"w": torch_conv_transpose_weight(w) if transposed else torch_conv_weight(w)}
    if prefix + ".bias" in sd:
        out["b"] = state_array(sd[prefix + ".bias"])
    return out


def _import_act(sd, prefix, use_snake) -> dict:
    if not use_snake:
        return {}
    return {"alpha": state_array(sd[prefix + ".alpha"]), "beta": state_array(sd[prefix + ".beta"])}


def _import_res_unit(sd, prefix, use_snake) -> dict:
    return {"act1": _import_act(sd, f"{prefix}.layers.0", use_snake),
            "conv1": _import_conv(sd, f"{prefix}.layers.1"),
            "act2": _import_act(sd, f"{prefix}.layers.2", use_snake),
            "conv2": _import_conv(sd, f"{prefix}.layers.3")}


def params_from_state_dict(sd: Dict[str, Any], cfg: OobleckConfig, prefix: str = "",
                           device="cuda") -> dict:
    """An AudioAutoencoder state dict (encoder.layers.* / decoder.layers.*;
    values torch tensors or numpy arrays) -> this module's f32 tree on
    `device`. `prefix` reaches a nested one, e.g. 'pretransform.model.'
    inside the SAO-1.0 diffusion checkpoint."""
    g = lambda s: prefix + s
    n = len(cfg.c_mults)
    snake = cfg.use_snake
    enc: Dict[str, Any] = {
        "in_conv": _import_conv(sd, g("encoder.layers.0")),
        "blocks": [],
        "out_act": _import_act(sd, g(f"encoder.layers.{n + 1}"), snake),
        "out_conv": _import_conv(sd, g(f"encoder.layers.{n + 2}")),
    }
    for i in range(n):
        base = g(f"encoder.layers.{i + 1}.layers")
        enc["blocks"].append({
            "res": [_import_res_unit(sd, f"{base}.{j}", snake) for j in range(3)],
            "act": _import_act(sd, f"{base}.3", snake),
            "down": _import_conv(sd, f"{base}.4"),
        })
    dec: Dict[str, Any] = {
        "in_conv": _import_conv(sd, g("decoder.layers.0")),
        "blocks": [],
        "out_act": _import_act(sd, g(f"decoder.layers.{n + 1}"), snake),
        "out_conv": _import_conv(sd, g(f"decoder.layers.{n + 2}")),
    }
    dec["out_conv"].pop("b", None)
    for i in range(n):
        base = g(f"decoder.layers.{i + 1}.layers")
        dec["blocks"].append({
            "act": _import_act(sd, f"{base}.0", snake),
            "up": _import_conv(sd, f"{base}.1", transposed=True),
            "res": [_import_res_unit(sd, f"{base}.{j + 2}", snake) for j in range(3)],
        })
    return params_from_jax({"encoder": enc, "decoder": dec}, device=device)


def load_pretrained(config_path: str, ckpt_path: str, device="cuda"):
    """model_config.json + a .safetensors / .pt checkpoint -> (cfg, params)."""
    from ..lm.convert import load_torch_checkpoint

    with open(config_path) as f:
        cfg = OobleckConfig.from_model_config(json.load(f))
    sd = load_torch_checkpoint(ckpt_path)
    prefix = "pretransform.model." if any(k.startswith("pretransform.model.") for k in sd) else ""
    return cfg, params_from_state_dict(sd, cfg, prefix=prefix, device=device)
