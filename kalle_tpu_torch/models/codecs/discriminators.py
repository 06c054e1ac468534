"""Waveform discriminators for codec GAN training (port of
kalle_tpu/models/codecs/discriminators.py): a multi-period (MPD) and a
multi-resolution STFT (MRD) discriminator, each a stack of strided NWC
convs, returning (logits, features) lists for the adversarial and
feature-matching losses.

The layout is the JAX package's, so both run one set of weights through
`bridge.params_from_jax`: `{"mpd": [stack], "mrd": [stack]}`, a stack a
list of `{"w": (K, C_in, C_out), "b": (C_out,)}`. The MPD folds each
period's phases into channels by reshaping the NWC tensor (B, T, C) ->
(B, T/p, p*C) (phase-major, audio channel fastest); the MRD convolves
`ops.mel.stft_mag` magnitudes of each audio channel stacked along the
channel axis, and skips a resolution longer than the clip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d
from ...ops.mel import stft_mag


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    mrd_resolutions: Tuple[Tuple[int, int, int], ...] = (
        (1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
    channels: int = 32
    n_layers: int = 4
    in_channels: int = 1  # audio channels (2 for the stereo Oobleck)

    @staticmethod
    def tiny(in_channels: int = 1) -> "DiscriminatorConfig":
        return DiscriminatorConfig(periods=(2, 3), mrd_resolutions=((256, 64, 256),),
                                   channels=8, n_layers=2, in_channels=in_channels)

    @staticmethod
    def encodec_stereo() -> "DiscriminatorConfig":
        """The stereo Oobleck's discriminator: the reference Encodec
        discriminator's scales 2048..128 at 0.75 overlap, 32 filters, on
        per-channel STFT magnitudes."""
        scales = (2048, 1024, 512, 256, 128)
        return DiscriminatorConfig(periods=(2, 3, 5, 7, 11),
                                   mrd_resolutions=tuple((s, s // 4, s) for s in scales),
                                   channels=32, n_layers=4, in_channels=2)


def init_params(cfg: DiscriminatorConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params: conv weights and biases uniform(±1/sqrt(C_in*K))."""
    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(cin * k)

        def u(*shape):
            r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return r * (2 * bound) - bound

        return {"w": u(k, cin, cout), "b": u(cout)}

    def stack(cin):
        layers, cout = [], cfg.channels
        for _ in range(cfg.n_layers):
            layers.append(conv(5, cin, cout))
            cin, cout = cout, min(cout * 2, 512)
        layers.append(conv(3, cin, 1))
        return layers

    return {"mpd": [stack(p * cfg.in_channels) for p in cfg.periods],
            "mrd": [stack((n_fft // 2 + 1) * cfg.in_channels)
                    for n_fft, _, _ in cfg.mrd_resolutions]}


def _run_stack(layers, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    feats = []
    for p in layers[:-1]:
        x = F.leaky_relu(conv1d(x, p["w"], p["b"], stride=2, padding=2), 0.1)
        feats.append(x)
    p = layers[-1]
    return conv1d(x, p["w"], p["b"], padding=1), feats


def forward(params: dict, cfg: DiscriminatorConfig, wav: torch.Tensor
            ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """wav (B, C, T), C == cfg.in_channels -> (logits list, feature lists):
    the periods' first, then the resolutions that fit the clip."""
    x = wav.transpose(1, 2)  # (B, T, C)
    b, t, c = x.shape
    logits, feats = [], []
    for stack, period in zip(params["mpd"], cfg.periods):
        xp = F.pad(x, (0, 0, 0, (-t) % period)).reshape(b, -1, period * c)
        lg, f = _run_stack(stack, xp)
        logits.append(lg)
        feats.append(f)
    for stack, (n_fft, hop, win) in zip(params["mrd"], cfg.mrd_resolutions):
        if wav.shape[-1] < n_fft:
            continue
        mag = torch.cat([stft_mag(wav[:, ch, :], n_fft, hop, win, power=1.0)
                         for ch in range(wav.shape[1])], dim=1)  # (B, C*F, T')
        lg, f = _run_stack(stack, mag.transpose(1, 2))
        logits.append(lg)
        feats.append(f)
    return logits, feats
