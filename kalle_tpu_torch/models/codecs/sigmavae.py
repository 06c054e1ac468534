"""SigmaVAE acoustic codec (port of kalle_tpu/models/codecs/sigmavae.py).

24 kHz mono, 64-dim latents at 7.5 Hz (strides 4*4*5*5*8 = 3200). The
encoder is a causal conv, then per stage a causal strided downsampling
conv and ConvNeXt residual blocks (RMSNorm -> causal depthwise conv k=7 ->
GEGLU MLP -> residual), then a pointwise head to the latent means (the
variance is fixed at `sigma`; `sample` adds the noise). The decoder
mirrors it: a pointwise input conv, per stage residual blocks and a causal
transposed conv upsampler, then RMSNorm, a causal conv and tanh.
Activations are NWC (B, T, C) and conv kernels (K, C_in/groups, C_out), as
in the JAX package.

A residual block in bf16 on the card, in the encoder or the decoder, runs
the fused kernel K4 (ops/kernels/convnext_block.py), as the JAX package
sends bf16 blocks off the CPU to its Pallas kernel, unless autograd
records it (K4 has no backward); any other block runs the plain ops (with
`gemm_blocks`, the depthwise conv folded into the up projection).
`encode` and `decode` are the inference entry points (no gradient);
`encode_nwc` and `decode_nwc` are differentiable, for codec training. The
VibeVoice-schema torch state dict import and export are at the bottom of
the file.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...bridge import params_to_numpy, tree_leaves
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
    # plain blocks: fold the depthwise conv into the GEGLU up projection as
    # one dense k-tap causal conv (W_eff[j] = diag(dw[j]) @ W_up, b_eff =
    # b_up + b_dw @ W_up), the same function; opt-in, no config sets it
    gemm_blocks: bool = False

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


def _records(x: torch.Tensor, p: dict) -> bool:
    """Whether autograd records a block on x with params p."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))


def _block(x: torch.Tensor, p: dict, cfg: SigmaVAEConfig) -> torch.Tensor:
    if (cfg.fused_blocks and cfg.kernel == 7 and x.dtype == torch.bfloat16
            and x.is_cuda and not _records(x, p)):
        # the convs hand back NWC views of NCW tensors; K4 reads (B, T, C) rows
        return convnext_block(x.contiguous(), p["norm"], p["dw"]["w"], p["dw"]["b"],
                              p["up"]["w"], p["up"]["b"], p["down"]["w"],
                              p["down"]["b"])
    h = _rms_norm(x, p["norm"])
    k = cfg.kernel
    if cfg.gemm_blocks:
        w_eff = p["dw"]["w"].reshape(k, -1, 1) * p["up"]["w"][0][None]
        b_eff = p["up"]["b"] + p["dw"]["b"] @ p["up"]["w"][0]
        h = conv1d(h, w_eff, b_eff, padding=(k - 1, 0))  # causal
    else:
        h = conv1d(h, p["dw"]["w"], p["dw"]["b"], groups=x.shape[-1],
                   padding=(k - 1, 0))  # causal depthwise
        h = h @ p["up"]["w"][0] + p["up"]["b"]
    v, g = h.chunk(2, dim=-1)
    h = v * F.gelu(g, approximate="tanh")
    return x + (h @ p["down"]["w"][0] + p["down"]["b"])


def encode_nwc(params: dict, cfg: SigmaVAEConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, 1) -> latent means (B, T // hop, d); differentiable."""
    p = params["encoder"]
    x = conv1d(x, p["pre"]["w"], p["pre"]["b"], padding=(cfg.kernel - 1, 0))
    for st, s in zip(p["stages"], cfg.strides):
        # causal strided downsample (kernel 2s): left pad s, so frame t sees
        # only the past
        x = conv1d(x, st["down"]["w"], st["down"]["b"], stride=s, padding=(s, 0))
        for blk in st["blocks"]:
            x = _block(x, blk, cfg)
    return conv1d(x, p["head"]["w"], p["head"]["b"])


def decode_nwc(params: dict, cfg: SigmaVAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, T', d) -> wav (B, T' * hop, 1); differentiable."""
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
def encode(params: dict, cfg: SigmaVAEConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, 1, T) or (B, T) -> latent means (B, T // hop, d)."""
    if wav.dim() == 2:
        wav = wav[:, None, :]
    return encode_nwc(params, cfg, wav.transpose(1, 2))


@torch.no_grad()
def decode(params: dict, cfg: SigmaVAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, T, d) or (B, d, T) -> wav (B, 1, T * hop) at 24 kHz."""
    z = _orient_btd(latents, cfg.latent_dim)
    return decode_nwc(params, cfg, z).transpose(1, 2)


def sample(generator: Optional[torch.Generator], mean: torch.Tensor, sigma: float = 0.5,
           dist_type: str = "fix") -> torch.Tensor:
    """A latent drawn around the encoder's means. "fix": mean + sigma * N(0, 1);
    "gaussian": a std drawn per row, N(0, 1) * sigma / 0.8, times N(0, 1)
    noise (two draws, in that order); anything else: the mean itself."""
    def normal(shape):
        return torch.randn(shape, generator=generator, device=mean.device, dtype=mean.dtype)

    if dist_type == "fix":
        return mean + sigma * normal(mean.shape)
    if dist_type == "gaussian":
        b = mean.shape[0]
        std = (normal((b,)) * (sigma / 0.8)).reshape((b,) + (1,) * (mean.dim() - 1))
        return mean + std * normal(mean.shape)
    return mean


# ---------------------------------------------------------------------------
# torch state-dict import/export
# ---------------------------------------------------------------------------
#
# The VibeVoice acoustic tokenizer's naming schema, as the JAX package
# assumes it (one torch module a node of this architecture):
#
#   encoder.pre.{weight,bias}                         Conv1d (cout, cin, k)
#   encoder.stages.{i}.down.{weight,bias}             strided Conv1d
#   encoder.stages.{i}.blocks.{j}.norm.weight         RMS-norm scale (ch,)
#   encoder.stages.{i}.blocks.{j}.dw.{weight,bias}    depthwise Conv1d
#   encoder.stages.{i}.blocks.{j}.up.{weight,bias}    1x1 Conv1d (GEGLU)
#   encoder.stages.{i}.blocks.{j}.down.{weight,bias}  1x1 Conv1d
#   encoder.head.{weight,bias}                        1x1 Conv1d -> latent_dim
#   decoder.pre / decoder.stages.{i}.{blocks,up} / decoder.post_norm.weight
#   / decoder.post.{weight,bias}                      mirror; `up` is a
#                                                     ConvTranspose1d (cin, cout, k)
#
# An `acoustic_tokenizer.`, `module.` or `model.` prefix is stripped. torch
# Conv1d weights (cout, cin/groups, k) map to NWC kernels (k, cin/groups,
# cout); ConvTranspose1d weights (cin, cout, k) map to (k, cin, cout), the
# layout conv_transpose1d_causal takes.

_PREFIXES = ("acoustic_tokenizer.", "module.", "model.")


def _strip_prefix(name: str) -> str:
    for p in _PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def params_from_torch_state_dict(sd: Dict[str, Any], cfg: SigmaVAEConfig,
                                 device="cuda") -> dict:
    """Import a VibeVoice-shaped torch state dict (schema above; values are
    torch tensors or numpy arrays) as this module's param tree on `device`."""
    tsd = {_strip_prefix(k): torch.as_tensor(v).detach().clone() for k, v in sd.items()}

    def conv(name, transposed=False):
        w = tsd[f"{name}.weight"].permute((2, 0, 1) if transposed else (2, 1, 0))
        return {"w": w.contiguous().to(device), "b": tsd[f"{name}.bias"].to(device)}

    def block(name):
        return {"norm": tsd[f"{name}.norm.weight"].to(device), "dw": conv(f"{name}.dw"),
                "up": conv(f"{name}.up"), "down": conv(f"{name}.down")}

    stages = range(len(cfg.strides))
    blocks = range(cfg.blocks_per_stage)
    enc = {"pre": conv("encoder.pre"),
           "stages": [{"down": conv(f"encoder.stages.{i}.down"),
                       "blocks": [block(f"encoder.stages.{i}.blocks.{j}") for j in blocks]}
                      for i in stages],
           "head": conv("encoder.head")}
    dec = {"pre": conv("decoder.pre"),
           "stages": [{"blocks": [block(f"decoder.stages.{i}.blocks.{j}") for j in blocks],
                       "up": conv(f"decoder.stages.{i}.up", transposed=True)}
                      for i in stages],
           "post_norm": tsd["decoder.post_norm.weight"].to(device),
           "post": conv("decoder.post")}
    return {"encoder": enc, "decoder": dec}


def state_dict_from_params(params: dict, cfg: SigmaVAEConfig) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_torch_state_dict`: torch-layout numpy
    arrays on the host (bf16 leaves as f32)."""
    out: Dict[str, np.ndarray] = {}

    def put_conv(name, p, transposed=False):
        out[f"{name}.weight"] = np.ascontiguousarray(
            np.transpose(p["w"], (1, 2, 0) if transposed else (2, 1, 0)))
        out[f"{name}.bias"] = p["b"]

    def put_block(name, p):
        out[f"{name}.norm.weight"] = p["norm"]
        for part in ("dw", "up", "down"):
            put_conv(f"{name}.{part}", p[part])

    params = params_to_numpy(params)
    enc, dec = params["encoder"], params["decoder"]
    put_conv("encoder.pre", enc["pre"])
    for i, st in enumerate(enc["stages"]):
        put_conv(f"encoder.stages.{i}.down", st["down"])
        for j, b in enumerate(st["blocks"]):
            put_block(f"encoder.stages.{i}.blocks.{j}", b)
    put_conv("encoder.head", enc["head"])
    put_conv("decoder.pre", dec["pre"])
    for i, st in enumerate(dec["stages"]):
        for j, b in enumerate(st["blocks"]):
            put_block(f"decoder.stages.{i}.blocks.{j}", b)
        put_conv(f"decoder.stages.{i}.up", st["up"], transposed=True)
    out["decoder.post_norm.weight"] = dec["post_norm"]
    put_conv("decoder.post", dec["post"])
    return out
