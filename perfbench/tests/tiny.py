"""A tiny configuration and traffic for the CPU tests of the benchmark."""
import copy
import json

from perfbench.common import HERE
from perfbench.drivers import Run

CFG = {
    "name": "tiny", "reduced": [], "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "rope_scaling": None,
    "vocab_size": 300, "max_position_embeddings": 512,
    "llasa": {"audio_special_tokens": 8, "latent_dim": 8, "audio_proj_dim": 64,
              "head_variant": "sigma", "sigma": 0.5, "codec": "sigma"},
    "serve": {"dtype": "float32", "layer_weights": "int8", "kv_cache_dtype": "float32",
              "codec_dtype": "float32"},
    "train": {"param_dtype": "float32", "dtype": "float32", "use_flash_attention": False},
}

CODEC = {"latent_dim": 8, "strides": [2, 4], "channels": [4, 8], "blocks_per_stage": 1}


def stream_run(seed: int = 2 ** 33 + 5, seconds: float = 1.5, **traffic) -> Run:
    tr = json.loads((HERE / "traffic" / "stream-b128.json").read_text())
    tr.update(batch=4, chunk_frames=2, stream_ctx=2, prompt_buckets=[16, 32], max_frames=9,
              text_chars=[5, 20], rate_per_s=8.0, ramp_s=0.5, tail_s=20.0, trace_s=0.5,
              check_requests=3, codec=CODEC)
    tr.update(traffic)
    return Run(cell="tiny.stream", cfg=copy.deepcopy(CFG), traffic=tr,
               limits={"frame_gap": 1e-3, "pcm_gap": 1e-3}, seed=seed, seconds=seconds,
               trace=False, device="cpu")


def train_run(seed: int = 2 ** 33 + 7, seconds: float = 1.0, **traffic) -> Run:
    cfg = copy.deepcopy(CFG)
    cfg["num_key_value_heads"] = 4
    tr = json.loads((HERE / "traffic" / "train-dyn11k.json").read_text())
    tr.update(rows=60, text_chars=[5, 20], frames=[4, 30], max_token_length=200,
              batch_size=4, length_buckets=[16, 32, 48, 64], warmup_steps=2, lr=1e-3,
              trace_after_steps=1)
    tr.update(traffic)
    return Run(cell="tiny.train", cfg=cfg, traffic=tr,
               limits={"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}, seed=seed,
               seconds=seconds, trace=False, device="cpu")


def synth_run(seed: int = 2 ** 33 + 9, seconds: float = 1.0, **traffic) -> Run:
    tr = json.loads((HERE / "traffic" / "synth-b256.json").read_text())
    tr.update(batch=4, max_frames=6, prompt_buckets=[16, 32], text_chars=[5, 20],
              check_rows=3, trace_from_step=1, trace_steps=3, codec=CODEC)
    tr.update(traffic)
    return Run(cell="tiny.synth", cfg=copy.deepcopy(CFG), traffic=tr,
               limits={"frame_gap": 1e-3, "pcm_gap": 1e-3}, seed=seed, seconds=seconds,
               trace=False, device="cpu")
