"""Configuration for the PyTorch port.

Frozen dataclasses with the same names and defaults as the JAX package's
`kalle_tpu/core/config.py` (`RopeScaling`, `LlamaConfig`, `LlasaConfig`,
`TrainConfig`, `DataConfig`, `ExperimentConfig`) and its YAML loader,
copied rather than imported so the port never loads the JAX package. The
TPU-only switches (scan unrolling, the decode-kernel batch gate) and the
fields only unported code reads (speaker and flow KL weights, speaker
dropout, stream delay, codec paths) are left out; YAML keys naming them
are ignored.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

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
    # training forward: recompute each layer in the backward
    # (torch.utils.checkpoint); "full" recomputes everything, "dots" saves
    # the matmul outputs and recomputes the rest
    remat: bool = False
    remat_policy: str = "full"
    # route the training forward's attention through the flash kernels
    # (K5-K7) when t % 128 == 0; llama.forward turns it off on the CPU
    # unless asked
    use_flash_attention: bool = True
    # "int8" stores the KV cache quantized with per-(token, kv-head) absmax
    # scales; anything else keeps it in `dtype`
    kv_cache_dtype: str = "bfloat16"
    # microbatches streamed through the pipeline stages when the mesh has a
    # pp axis (parallel/pipeline.py); the per-rank batch must divide by it.
    # Bubble fraction (pp - 1) / (pp_microbatches + pp - 1)
    pp_microbatches: int = 4
    # pipeline training schedule when pp > 1: "gpipe" (every microbatch's
    # stage inputs live through the backward, parallel/pipeline.py) or
    # "1f1b" (at most pp in flight, parallel/pipeline_1f1b.py); same loss
    # and gradients. Forwards outside training always run GPipe
    pp_schedule: str = "gpipe"

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


def flagship_cfg(dtype: str = "bfloat16", param_dtype: str = "bfloat16") -> LlasaConfig:
    """The flagship model (copy of `__graft_entry__._flagship_cfg`): the
    Llama-3.2-1B backbone, sigma head, 64-d latents, audio_proj 2048."""
    llama = dataclasses.replace(LlamaConfig(), dtype=dtype, param_dtype=param_dtype)
    return LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=2048, head_variant="sigma")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (JAX `TrainConfig`). dp/tp/fsdp/pp size the
    mesh (parallel/mesh.make_mesh; dp -1 takes the ranks the others leave)
    when a process group is initialized."""

    lr: float = 5e-5
    weight_decay: float = 1e-2
    warmup_steps: int = 1000
    total_steps: int = 1_000_000
    scheduler: str = "cosine"
    gradient_accumulation_steps: int = 1
    audio_loss_weight: float = 1.0
    end_loss_weight: float = 0.002
    save_interval: int = 5000
    log_interval: int = 100
    seed: int = 42
    max_grad_norm: Optional[float] = None
    # emit metrics["grad_norm"] (the global norm before clipping)
    log_grad_norm: bool = False
    dp: int = -1
    tp: int = 1
    fsdp: bool = False
    pp: int = 1


@dataclass(frozen=True)
class DataConfig:
    """Dataset config (JAX `DataConfig`)."""

    meta_path: str = ""
    latent_kind: str = "sigma"  # "sigma" (.npy (1,T,64)) | "stableaudio" (.npy (1,128,T))
    max_token_length: int = 11000  # dynamic batch token budget
    batch_size: int = 16
    use_dynamic: bool = True
    num_workers: int = 4
    prefetch_size: int = 64
    max_length: int = 2048
    # sequence lengths the batcher pads up to (multiples of 128: the flash
    # kernels' block)
    length_buckets: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048)


@dataclass(frozen=True)
class ExperimentConfig:
    project_name: str = "kalle_tpu"
    exp_dir: str = "/tmp/kalle_tpu_exp"
    llm_model_name_or_path: str = ""
    tokenizer_path: str = ""
    start_checkpoint: str = ""
    model: LlasaConfig = field(default_factory=LlasaConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    @property
    def log_dir(self) -> str:
        return os.path.join(self.exp_dir, self.project_name, "logs")

    @property
    def output_dir(self) -> str:
        return os.path.join(self.exp_dir, self.project_name, "output")


def _get(d: dict, key: str, default: Any = None) -> Any:
    v = d.get(key, default)
    return default if v is None else v


def load_experiment_config(path_or_dict: Any) -> ExperimentConfig:
    """Load a reference-schema experiment YAML (or its dict) into the typed
    config tree, as the JAX loader does: unknown keys are ignored and the
    reference's `use_flash_attation` spelling is read. PyYAML is imported
    only when a path is given."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        import yaml

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f)
    else:
        raw = dict(path_or_dict)

    m = _get(raw, "model", {})
    latent_dim = int(_get(m, "latent_dim", 64))
    head_variant = str(_get(m, "head_variant", _get(raw, "head_variant", "sigma")))

    llama_overrides = _get(m, "llama", {})
    llama = LlamaConfig()
    if llama_overrides:
        valid = {f.name for f in dataclasses.fields(LlamaConfig)}
        kwargs = {k: v for k, v in llama_overrides.items()
                  if k in valid and k != "rope_scaling"}
        if isinstance(llama_overrides.get("rope_scaling"), dict):
            kwargs["rope_scaling"] = RopeScaling(**llama_overrides["rope_scaling"])
        elif "rope_scaling" in llama_overrides and llama_overrides["rope_scaling"] is None:
            kwargs["rope_scaling"] = None
        llama = dataclasses.replace(llama, **kwargs)
    # the reference YAML spells it "use_flash_attation" (typo kept verbatim)
    llama = dataclasses.replace(llama, use_flash_attention=bool(
        _get(raw, "use_flash_attation", _get(raw, "use_flash_attention", True))))

    model = LlasaConfig(
        llama=llama,
        latent_dim=latent_dim,
        audio_proj_dim=int(_get(m, "audio_proj_dim", 2048)),
        head_variant=head_variant,
    )

    ds = _get(raw, "dataset", {})
    bg = _get(raw, "batch_generator", {})
    dp = _get(raw, "datapool", {})
    data = DataConfig(
        meta_path=str(_get(ds, "meta_path", "")),
        latent_kind=str(_get(ds, "latent_kind", "sigma")),
        max_token_length=int(_get(bg, "max_token_length", 11000)),
        batch_size=int(_get(bg, "batch_size", 16)),
        use_dynamic=bool(_get(bg, "use_dynamic", True)),
        num_workers=int(_get(dp, "num_workers", 4)),
        prefetch_size=int(_get(dp, "prefetch_size", 64)),
    )

    train = TrainConfig(
        lr=float(_get(raw, "lr", 5e-5)),
        weight_decay=float(_get(raw, "weight_decay", 1e-2)),
        warmup_steps=int(_get(raw, "warmup_steps", 1000)),
        total_steps=int(_get(raw, "total_steps", 1_000_000)),
        scheduler=str(_get(raw, "scheduler", "cosine")),
        gradient_accumulation_steps=int(_get(raw, "gradient_accumulation_steps", 1)),
        audio_loss_weight=float(_get(raw, "audio_loss_weight", 1.0)),
        end_loss_weight=float(_get(raw, "end_loss_weight", 0.002)),
        save_interval=int(_get(raw, "save_interval", 5000)),
        log_interval=int(_get(raw, "log_interval", 100)),
        dp=int(_get(raw, "dp", -1)),
        tp=int(_get(raw, "tp", 1)),
        fsdp=bool(_get(raw, "fsdp", False)),
        pp=int(_get(raw, "pp", 1)),
    )

    return ExperimentConfig(
        project_name=str(_get(raw, "project_name", "kalle_tpu")),
        exp_dir=str(_get(raw, "exp_dir", "/tmp/kalle_tpu_exp")),
        llm_model_name_or_path=str(_get(m, "llm_model_name_or_path", "")),
        tokenizer_path=str(_get(raw, "tokenizer_path", "")),
        start_checkpoint=str(_get(raw, "start_checkpoint", "")),
        model=model,
        train=train,
        data=data,
    )


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... -> the torch dtype of that name."""
    return getattr(torch, name)
