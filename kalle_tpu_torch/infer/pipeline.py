"""Codec facade (port of the sigma part of kalle_tpu/infer/pipeline.py:33-104).

Only the "sigma" codec is ported; the stableaudio and melvae codecs and
`InferTools` are not yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bridge import tree_map
from ..models.codecs import sigmavae


class Codec:
    """Uniform facade over the codec families (sigma only so far)."""

    def __init__(self, kind: str, cfg, params):
        if kind != "sigma":
            raise ValueError(f"codec {kind!r} is not ported (sigma only)")
        self.kind = kind
        self.cfg = cfg
        self.params = params
        self.dtype = torch.float32

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def samples_per_frame(self) -> int:
        """Audio samples produced per latent frame."""
        return int(self.cfg.hop)

    def astype(self, dtype) -> "Codec":
        """Cast the codec params; bf16 sends the residual blocks through K4
        on the card."""
        self.params = tree_map(lambda t: t.to(dtype), self.params)
        self.dtype = dtype
        return self

    def decode_latents(self, latents) -> np.ndarray:
        """latents (B, T, d) -> host audio (B, 1, T_audio) as float32."""
        device = self.params["decoder"]["pre"]["w"].device
        z = torch.as_tensor(latents, device=device).to(self.dtype)
        return sigmavae.decode(self.params, self.cfg, z).float().cpu().numpy()

    @staticmethod
    def random_init(kind: str = "sigma", generator: Optional[torch.Generator] = None,
                    device="cuda", **overrides) -> "Codec":
        """Random f32 params; `generator` defaults to one seeded 0 on
        `device`. `cfg=` or config fields may be passed as overrides."""
        if kind != "sigma":
            raise ValueError(f"codec {kind!r} is not ported (sigma only)")
        cfg = overrides.pop("cfg", None) or sigmavae.SigmaVAEConfig(**overrides)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return Codec(kind, cfg, sigmavae.init_params(cfg, generator, device))
