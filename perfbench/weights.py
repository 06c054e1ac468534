"""Seeded weights, made on the device by the benchmark and handed to the
program and, again from the same seed, to the reference.

Every leaf has a generator of its own (`sub_seed(seed, stream, leaf)`), so
one leaf can be drawn again alone. The trees have the program's layout
(layers stacked on axis 0, matmul weights (in, out)); the draws follow the
usual init: normal * 0.02 for the decoder's matrices, ones for the norms,
uniform(+-fan_in^-1/2) for the Llasa heads and the codec's convolutions.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .common import sub_seed

LM_STREAM, CODEC_STREAM = 1, 2


def _gen(seed: int, stream: int, leaf: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream, leaf))


def lm_leaves(s: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(path, shape, kind, scale) of each leaf of the Llasa tree, in draw
    order: kind "normal" (N(0, 1) * scale), "ones", or "uniform"
    (U(-scale, scale))."""
    h, f, L, d, p = s["hidden"], s["ffn"], s["layers"], s["latent"], s["audio_proj"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    return [
        ("llama.embed", (s["vocab"], h), "normal", 0.02),
        ("llama.layers.attn_norm", (L, h), "ones", 1.0),
        ("llama.layers.wq", (L, h, q), "normal", 0.02),
        ("llama.layers.wk", (L, h, kv), "normal", 0.02),
        ("llama.layers.wv", (L, h, kv), "normal", 0.02),
        ("llama.layers.wo", (L, q, h), "normal", 0.02),
        ("llama.layers.mlp_norm", (L, h), "ones", 1.0),
        ("llama.layers.wg", (L, h, f), "normal", 0.02),
        ("llama.layers.wu", (L, h, f), "normal", 0.02),
        ("llama.layers.wd", (L, f, h), "normal", 0.02),
        ("llama.final_norm", (h,), "ones", 1.0),
        ("audio_linear.w", (d, p), "uniform", d ** -0.5),
        ("audio_linear.b", (p,), "uniform", d ** -0.5),
        ("distribution_linear.w0", (p, d), "uniform", p ** -0.5),
        ("distribution_linear.b0", (d,), "uniform", p ** -0.5),
        ("distribution_linear.w2", (d, d), "uniform", d ** -0.5),
        ("distribution_linear.b2", (d,), "uniform", d ** -0.5),
    ]


def draw(shape, kind: str, scale: float, gen: torch.Generator, device,
         dtype: torch.dtype) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    r = (torch.randn if kind == "normal" else torch.rand)(
        shape, generator=gen, device=device, dtype=torch.float32)
    if kind == "uniform":
        r = r.mul_(2 * scale).sub_(scale)
    else:
        r = r.mul_(scale)
    return r.to(dtype)


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def lm_leaf(s: dict, seed: int, index: int, device, dtype=torch.float32) -> torch.Tensor:
    """Leaf number `index` of `lm_leaves` drawn alone. The heads are f32 in
    every tree (the program keeps them so)."""
    path, shape, kind, scale = lm_leaves(s)[index]
    if not path.startswith("llama."):
        dtype = torch.float32
    return draw(shape, kind, scale, _gen(seed, LM_STREAM, index, device), device, dtype)


def lm_params(s: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The whole Llasa tree: the decoder in `dtype`, the heads in f32."""
    tree: Dict = {}
    for i, (path, *_rest) in enumerate(lm_leaves(s)):
        _put(tree, path, lm_leaf(s, seed, i, device, dtype))
    return tree


# ---------------------------------------------------------------------------
# the SigmaVAE codec (defaults of the program's SigmaVAEConfig)
# ---------------------------------------------------------------------------

SIGMAVAE = {"latent_dim": 64, "sample_rate": 24000, "strides": (4, 4, 5, 5, 8),
            "channels": (32, 64, 128, 256, 512), "blocks_per_stage": 2, "mlp_ratio": 2,
            "kernel": 7}


def codec_decoder_leaves(c: dict = SIGMAVAE) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """The decoder's leaves (the only half a decode reads), in draw order:
    (path, shape, kind, scale), conv kernels (K, C_in/groups, C_out)."""
    out = []

    def conv(path, k, cin, cout, groups=1):
        bound = 1.0 / math.sqrt((cin // groups) * k)
        out.append((f"{path}.w", (k, cin // groups, cout), "uniform", bound))
        out.append((f"{path}.b", (cout,), "uniform", bound))

    chs, strides = c["channels"], c["strides"]
    conv("decoder.pre", 1, c["latent_dim"], chs[-1])
    for j, i in enumerate(reversed(range(len(strides)))):
        cin = chs[i + 1] if i + 1 < len(chs) else chs[-1]
        for b in range(c["blocks_per_stage"]):
            path = f"decoder.stages.{j}.blocks.{b}"
            hid = c["mlp_ratio"] * cin
            out.append((f"{path}.norm", (cin,), "ones", 1.0))
            conv(f"{path}.dw", c["kernel"], cin, cin, groups=cin)
            conv(f"{path}.up", 1, cin, 2 * hid)
            conv(f"{path}.down", 1, hid, cin)
        conv(f"decoder.stages.{j}.up", 2 * strides[i], cin, chs[i])
    out.append(("decoder.post_norm", (chs[0],), "ones", 1.0))
    conv("decoder.post", c["kernel"], chs[0], 1)
    return out


def codec_params(seed: int, device, dtype=torch.float32, c: dict = SIGMAVAE) -> dict:
    """The codec's decoder tree, in the program's layout (stages and blocks
    as lists)."""
    tree: Dict = {}
    for i, (path, shape, kind, scale) in enumerate(codec_decoder_leaves(c)):
        _put(tree, path, draw(shape, kind, scale, _gen(seed, CODEC_STREAM, i, device),
                              device, dtype))

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[k]) for k in sorted(node, key=int)]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def tree_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted path: leaf} of a nested dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        p = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(tree_paths(v, p + "."))
        else:
            out[p] = v
    return out

