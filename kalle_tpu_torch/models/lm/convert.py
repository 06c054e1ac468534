"""Reference checkpoints <-> the port's Llasa param tree (port of
kalle_tpu/models/lm/convert.py).

Covers:
  * HF Llama (`LlamaModel` / `LlamaForCausalLM`) state dicts: the backbone
    the reference fine-tunes (AutoModelForCausalLM.from_pretrained);
  * full Llasa checkpoints (`epoch_E_step_S.pt` state dicts: the backbone
    under `base_model.model.*` beside `audio_linear.*` and
    `distribution_linear.*`), in both directions.

Numpy is the interchange format, as in the JAX package: the converters
return nested dicts of f32 numpy arrays in the port's layout (layers
stacked on a leading L axis, matmul weights (in, out)), which
`bridge.params_from_jax` moves onto a device. So the port and the JAX
package read a state dict to the same bits. `safetensors` is imported only
for a `.safetensors` path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...bridge import state_array
from ...core.config import LlamaConfig, LlasaConfig

# the port's stacked layer weights -> (HF name suffix, stored transposed)
_LAYER_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wg": ("mlp.gate_proj.weight", True),
    "wu": ("mlp.up_proj.weight", True),
    "wd": ("mlp.down_proj.weight", True),
}


def llama_params_from_state_dict(sd: Dict, cfg: LlamaConfig, prefix: str = "model.") -> dict:
    """An HF Llama state dict -> the stacked layout (torch's nn.Linear
    stores (out, in); the port keeps (in, out)). A checkpoint with fewer
    embedding rows than cfg.vocab_size gets the new rows set to the mean
    embedding (resize_token_embeddings with the mean and no noise)."""
    def g(name):
        return state_array(sd[prefix + name])

    layers = {key: np.stack([g(f"layers.{i}.{suffix}").T if transpose
                             else g(f"layers.{i}.{suffix}")
                             for i in range(cfg.num_layers)]).astype(np.float32)
              for key, (suffix, transpose) in _LAYER_NAMES.items()}
    params = {"embed": g("embed_tokens.weight"), "layers": layers,
              "final_norm": g("norm.weight")}
    vocab = params["embed"].shape[0]
    if vocab < cfg.vocab_size:
        extra = np.broadcast_to(params["embed"].mean(axis=0, keepdims=True),
                                (cfg.vocab_size - vocab, params["embed"].shape[1]))
        params["embed"] = np.concatenate([params["embed"], extra], axis=0)
    return params


def llasa_params_from_state_dict(sd: Dict, cfg: LlasaConfig) -> dict:
    """A full Llasa state dict (base_model.* + audio_linear.* +
    distribution_linear.*) -> the port's Llasa param tree, numpy f32."""
    llama = llama_params_from_state_dict(sd, cfg.llama, prefix="base_model.model.")
    head = {
        "audio_linear": {"w": state_array(sd["audio_linear.weight"]).T,
                         "b": state_array(sd["audio_linear.bias"])},
        "distribution_linear": {"w0": state_array(sd["distribution_linear.0.weight"]).T,
                                "b0": state_array(sd["distribution_linear.0.bias"]),
                                "w2": state_array(sd["distribution_linear.2.weight"]).T,
                                "b2": state_array(sd["distribution_linear.2.bias"])},
    }
    return {"llama": llama, **head}


def llasa_state_dict_from_params(params: dict, cfg: LlasaConfig) -> Dict[str, torch.Tensor]:
    """The port's Llasa params (torch tensors on any device, or numpy) ->
    a reference-layout state dict of f32 CPU tensors, so reference tooling
    can read what the port trained. The head is the two-layer
    `distribution_linear.{0,2}` or, for a tree with a single Linear
    (`w`, `b`), `distribution_linear.{weight,bias}`."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(state_array(a)))

    sd: Dict[str, torch.Tensor] = {}
    ll = params["llama"]
    sd["base_model.model.embed_tokens.weight"] = t(ll["embed"])
    sd["base_model.model.norm.weight"] = t(ll["final_norm"])
    for key, (suffix, transpose) in _LAYER_NAMES.items():
        stacked = state_array(ll["layers"][key])
        for i in range(cfg.llama.num_layers):
            sd[f"base_model.model.layers.{i}.{suffix}"] = t(
                stacked[i].T if transpose else stacked[i])
    sd["audio_linear.weight"] = t(state_array(params["audio_linear"]["w"]).T)
    sd["audio_linear.bias"] = t(params["audio_linear"]["b"])
    dl = params["distribution_linear"]
    if "w0" in dl:
        sd["distribution_linear.0.weight"] = t(state_array(dl["w0"]).T)
        sd["distribution_linear.0.bias"] = t(dl["b0"])
        sd["distribution_linear.2.weight"] = t(state_array(dl["w2"]).T)
        sd["distribution_linear.2.bias"] = t(dl["b2"])
    else:
        sd["distribution_linear.weight"] = t(state_array(dl["w"]).T)
        sd["distribution_linear.bias"] = t(dl["b"])
    return sd


def load_torch_checkpoint(path: str) -> Dict:
    """A .pt or .safetensors checkpoint -> its state dict (a `.pt` holding
    {'state_dict': ...} or a {'generator': ...} codec checkpoint is
    unwrapped), on the CPU."""
    if path.endswith(".safetensors"):
        from safetensors import safe_open

        out = {}
        with safe_open(path, framework="np") as f:
            for k in f.keys():
                out[k] = f.get_tensor(k)
        return out
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "generator" in sd and all(
            hasattr(v, "shape") for v in sd["generator"].values()):
        sd = sd["generator"]
    return sd
