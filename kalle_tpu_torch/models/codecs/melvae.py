"""mel-VAE / BigVGANFlowVAE (port of kalle_tpu/models/codecs/melvae.py).

A strided-conv encoder to (B, 2d, T') mean||logs, a residual coupling flow
over z (mean-only WaveNet couplings with a channel flip between them), and
a BigVGAN decoder: ConvTranspose upsamplers and AMP blocks of anti-aliased
Snake/SnakeBeta activations around causal convs. By default 16 kHz mono,
640 samples a frame both ways (encoder strides 2*2*2*4*4*5, decoder
upsampling 5*4*4*2*2*2; 25 Hz), latent 512.

Public surface, as in the JAX package:
    forward(params, cfg, wav, generator)   -> (wav_hat, (z_p, m_q, logs_q))
    extract_latents(params, cfg, wav)      -> (B, 2*latent, T') mean||logs
    inference_from_latents(params, cfg, x, generator, do_sample) -> wav
    inference_from_mean_std(params, cfg, mean, logs_q, generator, do_sample)
    flow(params, cfg, z, reverse)          -> z'

External tensors are channel-first (B, C, T); inside, NWC. The convs are
cuDNN on the card and the snake activations plain torch in f32, as XLA
computes them in the JAX package: no Pallas kernel takes this codec. Each
draw comes from a `torch.Generator`, or from an injected `noise` tensor of
the draw's shape (a seam for holding the port against the JAX package,
whose draws torch cannot reproduce).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...bridge import params_from_jax, state_array
from ...ops.alias_free import alias_free_act
from ...ops.conv import conv1d, conv_transpose1d, snake, snake_beta
from .oobleck import _import_conv


@dataclasses.dataclass(frozen=True)
class MelVAEConfig:
    latent_dim: int = 512
    use_vae: bool = True
    in_channels: int = 1
    base_channels: int = 12
    downsample_channels: Tuple[int, ...] = (12, 24, 48, 96, 192, 384, 768)
    downsample_rates: Tuple[int, ...] = (2, 2, 2, 4, 4, 5)
    stacks: int = 6
    stack_kernel_size: int = 3
    stack_dilation_base: int = 2
    proj_kernel_size: int = 3
    flow_hidden_channels: int = 192
    n_flows: int = 4
    flow_kernel_size: int = 5
    flow_n_layers: int = 4
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (10, 8, 8, 4, 4, 4)
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    causal: bool = True
    sample_rate: int = 16000

    @property
    def hop(self) -> int:
        return int(np.prod(self.downsample_rates))

    @staticmethod
    def from_h(h: Dict[str, Any]) -> "MelVAEConfig":
        """Build from a reference h-config JSON (its AttrDict fields)."""
        g = h.get
        return MelVAEConfig(
            latent_dim=g("latent_dim", 512),
            use_vae=g("use_vae", True),
            downsample_channels=tuple(g("downsample_channels", (12, 24, 48, 96, 192, 384, 768))),
            downsample_rates=tuple(g("downsample_rates", (2, 2, 2, 4, 4, 5))),
            flow_hidden_channels=g("flow_hidden_channels", 192),
            upsample_initial_channel=g("upsample_initial_channel", 1024),
            upsample_rates=tuple(g("upsample_rates", (5, 4, 4, 2, 2, 2))),
            upsample_kernel_sizes=tuple(g("upsample_kernel_sizes", (10, 8, 8, 4, 4, 4))),
            resblock=str(g("resblock", "1")),
            resblock_kernel_sizes=tuple(g("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tuple(map(tuple, g("resblock_dilation_sizes",
                                                       ((1, 3, 5),) * 3))),
            activation=g("activation", "snakebeta"),
            snake_logscale=g("snake_logscale", True),
            causal=g("causal", True),
            sample_rate=g("sampling_rate", 16000),
        )

    @staticmethod
    def tiny() -> "MelVAEConfig":
        return MelVAEConfig(
            latent_dim=8, downsample_channels=(4, 8, 16), downsample_rates=(2, 4), stacks=2,
            flow_hidden_channels=8, n_flows=2, flow_n_layers=2, upsample_initial_channel=16,
            upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
        )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _same_pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def causal_conv(x, p, k, stride=1, dilation=1, causal=True):
    """The reference's custom Conv1d: causal pads d*(k-1) on the left, else
    'same' padding."""
    pad = (dilation * (k - 1), 0) if causal else _same_pad(k, dilation)
    return conv1d(x, p["w"], p.get("b"), stride=stride, padding=pad, dilation=dilation)


def causal_conv_t(x, p, k, stride, causal=True):
    """The reference's custom ConvTranspose1d: causal takes padding 0 and
    trims `stride` samples from the right, else padding (k - stride)//2."""
    if causal:
        y = conv_transpose1d(x, p["w"], p.get("b"), stride=stride, padding=0)
        return y[:, :-stride, :]
    return conv_transpose1d(x, p["w"], p.get("b"), stride=stride, padding=(k - stride) // 2)


def _act(x, p, cfg: MelVAEConfig):
    if cfg.activation == "snakebeta":
        f = lambda y: snake_beta(y, p["alpha"], p["beta"], cfg.snake_logscale)
    else:
        f = lambda y: snake(y, p["alpha"], cfg.snake_logscale)
    return alias_free_act(x, f)


def _normal(generator, like: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """N(0, 1) of like's shape: `noise` where given, else from `generator`."""
    if noise is not None:
        if noise.shape != like.shape:
            raise ValueError(f"noise {tuple(noise.shape)} for a draw of {tuple(like.shape)}")
        return noise.to(like.device, like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: MelVAEConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params in the JAX package's tree: convs uniform(±1/sqrt(fan
    in)) (the decoder's N(0, 0.01)), each flow's `post` zero (an identity
    coupling, as the reference initialises it), snake params 0 (logscale)
    or 1."""
    def conv(k, cin, cout, std=None):
        bound = 1.0 / math.sqrt(cin * k)
        if std is not None:
            w = torch.randn((k, cin, cout), generator=generator, device=device) * std
        else:
            w = torch.rand((k, cin, cout), generator=generator, device=device) * (2 * bound) - bound
        b = torch.rand((cout,), generator=generator, device=device) * (2 * bound) - bound
        return {"w": w, "b": b}

    def snake_p(ch):
        fill = torch.zeros if cfg.snake_logscale else torch.ones
        p = {"alpha": fill(ch, device=device)}
        if cfg.activation == "snakebeta":
            p["beta"] = fill(ch, device=device)
        return p

    chs = cfg.downsample_channels
    enc: Dict[str, Any] = {"pre": conv(cfg.proj_kernel_size, cfg.in_channels, chs[0]),
                           "downs": []}
    for (cin, cout), f in zip(zip(chs[:-1], chs[1:]), cfg.downsample_rates):
        down = conv(2 * f, cin, cout)
        stack = [{"c1": conv(cfg.stack_kernel_size, cout, cout),
                  "c2": conv(cfg.stack_kernel_size, cout, cout)} for _ in range(cfg.stacks)]
        enc["downs"].append({"down": down, "stack": stack})
    enc["post"] = conv(cfg.proj_kernel_size, chs[-1], cfg.latent_dim * (2 if cfg.use_vae else 1))

    half, hid = cfg.latent_dim // 2, cfg.flow_hidden_channels
    flows = []
    for _ in range(cfg.n_flows):
        pre = conv(1, half, hid)
        wn_in, wn_skip = [], []
        for i in range(cfg.flow_n_layers):
            wn_in.append(conv(cfg.flow_kernel_size, hid, 2 * hid))
            wn_skip.append(conv(1, hid, 2 * hid if i < cfg.flow_n_layers - 1 else hid))
        post = {"w": torch.zeros((1, hid, half), device=device),
                "b": torch.zeros((half,), device=device)}
        flows.append({"pre": pre, "wn_in": wn_in, "wn_skip": wn_skip, "post": post})

    up0 = cfg.upsample_initial_channel
    dec: Dict[str, Any] = {"conv_pre": conv(7, cfg.latent_dim, up0), "ups": [],
                           "resblocks": []}
    ch = up0
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        ch = up0 // (2 ** (i + 1))
        dec["ups"].append(conv(k, up0 // (2 ** i), ch, std=0.01))
        blocks = []
        for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            blk = {"convs1": [conv(kk, ch, ch, std=0.01) for _ in dd],
                   "convs2": ([conv(kk, ch, ch, std=0.01) for _ in dd]
                              if cfg.resblock == "1" else [])}
            blk["acts"] = [snake_p(ch) for _ in range(2 * len(dd) if cfg.resblock == "1"
                                                      else len(dd))]
            blocks.append(blk)
        dec["resblocks"].append(blocks)
    dec["post_act"] = snake_p(ch)
    dec["conv_post"] = conv(7, ch, 1, std=0.01)
    return {"encoder": enc, "flows": flows, "decoder": dec}


# ---------------------------------------------------------------------------
# forward pieces (NWC inside)
# ---------------------------------------------------------------------------

def _encoder_nwc(p, cfg: MelVAEConfig, x):
    # the projections are always 'same'-padded, never causal
    x = F.leaky_relu(causal_conv(x, p["pre"], cfg.proj_kernel_size, causal=False), 0.2)
    for blk, f in zip(p["downs"], cfg.downsample_rates):
        x = conv1d(x, blk["down"]["w"], blk["down"]["b"], stride=f, padding=_same_pad(2 * f))
        for i, st in enumerate(blk["stack"]):  # ResStack, LeakyReLU slope 0.01
            d = cfg.stack_dilation_base ** i
            h = conv1d(F.leaky_relu(x, 0.01), st["c1"]["w"], st["c1"]["b"], padding=d,
                       dilation=d)
            x = x + conv1d(F.leaky_relu(h, 0.01), st["c2"]["w"], st["c2"]["b"], padding=1)
        x = F.leaky_relu(x, 0.2)
    return causal_conv(x, p["post"], cfg.proj_kernel_size, causal=False)


def _wn(flow_p, cfg: MelVAEConfig, x):
    """The WaveNet block of a mean-only coupling (dilation 1)."""
    hid = cfg.flow_hidden_channels
    output = torch.zeros_like(x)
    for i in range(cfg.flow_n_layers):
        x_in = causal_conv(x, flow_p["wn_in"][i], cfg.flow_kernel_size, causal=cfg.causal)
        acts = torch.tanh(x_in[..., :hid]) * torch.sigmoid(x_in[..., hid:])
        rs = causal_conv(acts, flow_p["wn_skip"][i], 1, causal=cfg.causal)
        if i < cfg.flow_n_layers - 1:
            x = x + rs[..., :hid]
            output = output + rs[..., hid:]
        else:
            output = output + rs
    return output


def _flow_nwc(params, cfg: MelVAEConfig, z, reverse=False):
    """ResidualCouplingBlock with a channel flip after each coupling; the
    reverse pass walks the couplings backwards and un-flips first."""
    half = cfg.latent_dim // 2
    flows = params["flows"]
    for fp in (reversed(flows) if reverse else flows):
        if reverse:
            z = torch.flip(z, dims=(-1,))
        x0, x1 = z[..., :half], z[..., half:]
        h = _wn(fp, cfg, causal_conv(x0, fp["pre"], 1, causal=cfg.causal))
        m = causal_conv(h, fp["post"], 1, causal=cfg.causal)
        z = torch.cat([x0, x1 - m if reverse else x1 + m], dim=-1)  # mean only
        if not reverse:
            z = torch.flip(z, dims=(-1,))
    return z


def _amp_block(blk, cfg: MelVAEConfig, x):
    # the block's kernel size comes from its weights' shape, its dilations
    # from the config entry with that kernel size
    k = blk["convs1"][0]["w"].shape[0]
    dil = next(dd for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
               if kk == k)
    if cfg.resblock == "1":
        for c1, c2, d, a1, a2 in zip(blk["convs1"], blk["convs2"], dil, blk["acts"][::2],
                                     blk["acts"][1::2]):
            xt = causal_conv(_act(x, a1, cfg), c1, k, dilation=d, causal=cfg.causal)
            x = causal_conv(_act(xt, a2, cfg), c2, k, causal=cfg.causal) + x
    else:
        for c, d, a in zip(blk["convs1"], dil, blk["acts"]):
            x = causal_conv(_act(x, a, cfg), c, k, dilation=d, causal=cfg.causal) + x
    return x


def _decoder_nwc(params, cfg: MelVAEConfig, z):
    dec = params["decoder"]
    x = causal_conv(z, dec["conv_pre"], 7, causal=False)  # conv_pre is never causal
    for up, blocks, u, k in zip(dec["ups"], dec["resblocks"], cfg.upsample_rates,
                                cfg.upsample_kernel_sizes):
        x = causal_conv_t(x, up, k, u, causal=cfg.causal)
        xs = None
        for blk in blocks:
            h = _amp_block(blk, cfg, x)
            xs = h if xs is None else xs + h
        x = xs / len(blocks)
    x = causal_conv(_act(x, dec["post_act"], cfg), dec["conv_post"], 7, causal=cfg.causal)
    return torch.tanh(x)


# ---------------------------------------------------------------------------
# public API (channel-first outside)
# ---------------------------------------------------------------------------

def params_from_state_dict(sd: Dict[str, Any], cfg: MelVAEConfig, prefix: str = "",
                           device="cuda") -> dict:
    """A BigVGANFlowVAE torch state dict (the `generator` entry of a g_*
    checkpoint; torch tensors or numpy arrays) -> this module's f32 tree on
    `device`, weight norm folded."""
    g = lambda s: prefix + s
    nd = len(cfg.downsample_rates)
    snake_b = cfg.activation == "snakebeta"

    def act(base):
        a = {"alpha": state_array(sd[f"{base}.act.alpha"])}
        if snake_b:
            a["beta"] = state_array(sd[f"{base}.act.beta"])
        return a

    # the encoder's Sequential: 0 = pre, then (2 + 3i) = down, (3 + 3i) = ResStack
    enc: Dict[str, Any] = {"pre": _import_conv(sd, g("audio_encoder.generator.0.layer")),
                           "downs": []}
    for i in range(nd):
        stack_base = g(f"audio_encoder.generator.{3 + 3 * i}")
        enc["downs"].append({
            "down": _import_conv(sd, g(f"audio_encoder.generator.{2 + 3 * i}.layer")),
            "stack": [{"c1": _import_conv(sd, f"{stack_base}.layers.{j}.1"),
                       "c2": _import_conv(sd, f"{stack_base}.layers.{j}.3")}
                      for j in range(cfg.stacks)],
        })
    enc["post"] = _import_conv(sd, g(f"audio_encoder.generator.{2 + 3 * nd}.layer"))

    flows = []
    for i in range(cfg.n_flows):
        base = g(f"flow.flows.{2 * i}")
        flows.append({
            "pre": _import_conv(sd, f"{base}.pre"),
            "wn_in": [_import_conv(sd, f"{base}.enc.in_layers.{j}")
                      for j in range(cfg.flow_n_layers)],
            "wn_skip": [_import_conv(sd, f"{base}.enc.res_skip_layers.{j}")
                        for j in range(cfg.flow_n_layers)],
            "post": _import_conv(sd, f"{base}.post"),
        })

    nk = len(cfg.resblock_kernel_sizes)
    dec: Dict[str, Any] = {
        "conv_pre": _import_conv(sd, g("conv_pre")),
        "ups": [_import_conv(sd, g(f"ups.{i}.0"), transposed=True)
                for i in range(len(cfg.upsample_rates))],
        "resblocks": [],
        "post_act": act(g("activation_post")),
        "conv_post": _import_conv(sd, g("conv_post")),
    }
    for i in range(len(cfg.upsample_rates)):
        blocks = []
        for j, dd in enumerate(cfg.resblock_dilation_sizes[:nk]):
            base = g(f"resblocks.{i * nk + j}")
            one = cfg.resblock == "1"
            blocks.append({
                "convs1": [_import_conv(sd, f"{base}.convs1.{c}" if one else f"{base}.convs.{c}")
                           for c in range(len(dd))],
                "convs2": [_import_conv(sd, f"{base}.convs2.{c}") for c in range(len(dd))]
                if one else [],
                "acts": [act(f"{base}.activations.{a}")
                         for a in range(2 * len(dd) if one else len(dd))],
            })
        dec["resblocks"].append(blocks)
    return params_from_jax({"encoder": enc, "flows": flows, "decoder": dec}, device=device)


def load_pretrained(config_path: str, ckpt_path: str, device="cuda"):
    """h-config JSON + g_* checkpoint -> (cfg, params)."""
    from ..lm.convert import load_torch_checkpoint

    with open(config_path) as f:
        cfg = MelVAEConfig.from_h(json.load(f))
    return cfg, params_from_state_dict(load_torch_checkpoint(ckpt_path), cfg, device=device)


@torch.no_grad()
def extract_latents(params, cfg: MelVAEConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, 1, T) -> (B, 2*latent, T/hop) mean||logs."""
    return _encoder_nwc(params["encoder"], cfg, wav.transpose(1, 2)).transpose(1, 2)


def _sample(m, logs, generator, noise):
    return m + _normal(generator, m, noise) * torch.exp(logs)


@torch.no_grad()
def inference_from_latents(params, cfg: MelVAEConfig, x: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           do_sample: bool = True,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 2*latent, T') mean||logs (or (B, latent, T') when not sampling)
    -> wav (B, 1, T'*hop). A sample draws (B, T', latent) N(0, 1)."""
    z = x.transpose(1, 2)
    if cfg.use_vae and do_sample:
        z = _sample(z[..., :cfg.latent_dim], z[..., cfg.latent_dim:], generator, noise)
    return _decoder_nwc(params, cfg, z).transpose(1, 2)


@torch.no_grad()
def inference_from_mean_std(params, cfg: MelVAEConfig, mean: torch.Tensor,
                            logs_q: torch.Tensor, generator: Optional[torch.Generator] = None,
                            do_sample: bool = True,
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean / logs (B, latent, T') -> sample -> decode -> wav (B, 1, T'*hop)."""
    z = mean.transpose(1, 2)
    if do_sample:
        z = _sample(z, logs_q.transpose(1, 2), generator, noise)
    return _decoder_nwc(params, cfg, z).transpose(1, 2)


@torch.no_grad()
def flow(params, cfg: MelVAEConfig, z: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """(B, latent, T') -> (B, latent, T'), the residual coupling flow."""
    return _flow_nwc(params, cfg, z.transpose(1, 2), reverse=reverse).transpose(1, 2)


def forward(params, cfg: MelVAEConfig, wav: torch.Tensor,
            generator: Optional[torch.Generator] = None, freeze_encoder: bool = False,
            latent_mask_ratio: float = 0.0, noise: Optional[torch.Tensor] = None,
            mask_uniform: Optional[torch.Tensor] = None):
    """Training forward: encode -> sample -> flow(z), and decode. Returns
    (wav_hat, (z_p, m_q, logs_q)), all channel-first; differentiable.

    freeze_encoder stops gradients at the encoder's output;
    latent_mask_ratio zeroes that share of the latents before the DECODER
    only (the flow sees them whole). Draws: the sample's (B, T', latent)
    N(0, 1), then the mask's (B, T', latent) U(0, 1); `noise` and
    `mask_uniform` inject them."""
    enc = _encoder_nwc(params["encoder"], cfg, wav.transpose(1, 2))
    if freeze_encoder:
        enc = enc.detach()
    m_q, logs_q = enc[..., :cfg.latent_dim], enc[..., cfg.latent_dim:]
    z = _sample(m_q, logs_q, generator, noise)
    z_p = _flow_nwc(params, cfg, z)
    z_dec = z
    if latent_mask_ratio > 0.0:
        u = (mask_uniform.to(z.device, z.dtype) if mask_uniform is not None else
             torch.rand(z.shape, generator=generator, device=z.device, dtype=z.dtype))
        z_dec = torch.where(u >= latent_mask_ratio, z, torch.zeros_like(z))
    y = _decoder_nwc(params, cfg, z_dec)
    return (y.transpose(1, 2),
            (z_p.transpose(1, 2), m_q.transpose(1, 2), logs_q.transpose(1, 2)))
