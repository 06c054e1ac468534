"""Model configuration for the PyTorch port.

Frozen dataclasses with the same names and defaults as the JAX package's
`kalle_tpu/core/config.py` (`RopeScaling`, `LlamaConfig`, `LlasaConfig`),
copied rather than imported so the port never loads the JAX package. Only
the fields the inference path reads are kept; the TPU-only switches
(remat, flash attention, pipeline schedules, the decode-kernel batch gate)
have no meaning here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3 rope scaling (matches HF `rope_scaling` for Llama-3.2)."""

    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder backbone config. Defaults = Llama-3.2-1B-Instruct."""

    vocab_size: int = 128264  # 128256 + 8 audio special tokens
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = field(default_factory=RopeScaling)
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # dtype of freshly initialised params
    # "int8" stores the KV cache quantized with per-(token, kv-head) absmax
    # scales; anything else keeps it in `dtype`
    kv_cache_dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 300) -> "LlamaConfig":
        """Small config for unit tests / CPU."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_seq_len=128,
            dtype="float32",
        )


@dataclass(frozen=True)
class LlasaConfig:
    """Audio-LM head config.

    head_variant "sigma" emits the mean only, with sigma fixed at 0.5;
    "stableaudio" and "melvae" emit mean||log_scale (2 * latent_dim).
    """

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    latent_dim: int = 64
    audio_proj_dim: int = 2048
    head_variant: str = "sigma"
    sigma: float = 0.5
    label_std_scale: float = 1.25
    # end-of-speech detector: KL(pred || N(end_mean, end_std)) / d < thres
    # once min_frames frames are out
    end_kl_threshold: float = 0.5
    end_mean: float = 1.0
    end_std: float = 2.718281828459045  # exp(1)
    min_frames: int = 4

    @property
    def head_out_dim(self) -> int:
        return self.latent_dim if self.head_variant == "sigma" else 2 * self.latent_dim

    @staticmethod
    def tiny(head_variant: str = "sigma", latent_dim: int = 8) -> "LlasaConfig":
        return LlasaConfig(
            llama=LlamaConfig.tiny(),
            latent_dim=latent_dim,
            audio_proj_dim=64,
            head_variant=head_variant,
        )


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... -> the torch dtype of that name."""
    return getattr(torch, name)
