"""A configuration file (`perfbench/configs/<name>.json`) as plain sizes,
and as the program's `LlasaConfig`, with the check that the two agree.

`sizes` is what the reference and the operation counts read; it imports
nothing of the program. `llasa_config` builds the program's config for a
precision section ("serve" or "train") and `check_widths` holds it, and
the weights a run made, against the file before anything is timed.
"""
from __future__ import annotations

from typing import Dict

from .common import HERE, load_json


def load(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def sizes(cfg: dict) -> Dict[str, object]:
    """The model's sizes as the benchmark reads them."""
    ll = cfg["llasa"]
    heads = cfg["num_attention_heads"]
    return {
        "hidden": cfg["hidden_size"],
        "ffn": cfg["intermediate_size"],
        "layers": cfg["num_hidden_layers"],
        "heads": heads,
        "kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg.get("head_dim") or cfg["hidden_size"] // heads,
        "vocab": cfg["vocab_size"] + ll["audio_special_tokens"],
        "base_vocab": cfg["vocab_size"],
        "rope_theta": float(cfg["rope_theta"]),
        "rms_eps": float(cfg["rms_norm_eps"]),
        "latent": ll["latent_dim"],
        "audio_proj": ll["audio_proj_dim"],
        "sigma": float(ll["sigma"]),
        "max_positions": cfg["max_position_embeddings"],
    }


def llasa_config(cfg: dict, section: str):
    """The program's LlasaConfig for this file, in the precision of its
    `section` ("serve" or "train")."""
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig

    if cfg.get("rope_scaling") is not None:
        raise ValueError(f"{cfg['name']}: rope scaling is not modelled here")
    s = sizes(cfg)
    prec = cfg[section]
    llama = LlamaConfig(
        vocab_size=s["vocab"], hidden_size=s["hidden"], intermediate_size=s["ffn"],
        num_layers=s["layers"], num_heads=s["heads"], num_kv_heads=s["kv_heads"],
        head_dim=s["head_dim"], rope_theta=s["rope_theta"], rope_scaling=None,
        rms_norm_eps=s["rms_eps"], max_seq_len=s["max_positions"], dtype=prec["dtype"],
        param_dtype=prec.get("param_dtype", prec["dtype"]),
        use_flash_attention=bool(prec.get("use_flash_attention", True)),
        kv_cache_dtype=prec.get("kv_cache_dtype", "bfloat16"))
    ll = cfg["llasa"]
    return LlasaConfig(llama=llama, latent_dim=ll["latent_dim"],
                       audio_proj_dim=ll["audio_proj_dim"], head_variant=ll["head_variant"],
                       sigma=float(ll["sigma"]))


def check_widths(cfg: dict, lcfg, params: dict) -> None:
    """Raise unless the program's config and the weights it holds carry
    every width of the file, and the file changes nothing (`reduced`
    empty)."""
    if cfg.get("reduced"):
        raise ValueError(f"{cfg['name']}: reduced {cfg['reduced']}; this benchmark "
                         "runs its configurations uncut")
    s, ll = sizes(cfg), lcfg.llama
    want = {"hidden_size": s["hidden"], "intermediate_size": s["ffn"],
            "num_layers": s["layers"], "num_heads": s["heads"],
            "num_kv_heads": s["kv_heads"], "head_dim": s["head_dim"],
            "vocab_size": s["vocab"], "rope_theta": s["rope_theta"],
            "rms_norm_eps": s["rms_eps"]}
    got = {k: getattr(ll, k) for k in want}
    got_ll = {"latent_dim": lcfg.latent_dim, "audio_proj_dim": lcfg.audio_proj_dim,
              "sigma": lcfg.sigma}
    want_ll = {"latent_dim": s["latent"], "audio_proj_dim": s["audio_proj"],
               "sigma": s["sigma"]}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    bad.update({k: (got_ll[k], want_ll[k]) for k in want_ll if got_ll[k] != want_ll[k]})
    if ll.rope_scaling is not None:
        bad["rope_scaling"] = (ll.rope_scaling, None)
    h, f, L = s["hidden"], s["ffn"], s["layers"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    shapes = {"embed": (s["vocab"], h), "wq": (L, h, q), "wk": (L, h, kv),
              "wv": (L, h, kv), "wo": (L, q, h), "wg": (L, h, f), "wu": (L, h, f),
              "wd": (L, f, h)}
    lp = params["llama"]
    for k, shape in shapes.items():
        w = lp["embed"] if k == "embed" else lp["layers"][k]
        w = w["q"] if isinstance(w, dict) else w
        if tuple(w.shape) != shape:
            bad[f"weights.{k}"] = (tuple(w.shape), shape)
    if bad:
        raise ValueError(f"{cfg['name']}: the run's model differs from its file "
                         f"(got, file): {bad}")
