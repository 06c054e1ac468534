"""Llama-3.2 decoder backbone (port of kalle_tpu/models/lm/llama.py:28-159,
200-403 and 406-459): the KV-cached inference forward and the
full-sequence training forward.

Params keep the JAX layout: a dict whose `layers` entry stacks the L
transformer layers on a leading axis, matmul weights (in, out), optionally
int8 {'q','scale'} dicts (ops/quant.py).

The KV cache keeps the JAX package's layout too — keys transposed per head
(L, b, nkv, hd, C), values (L, b, nkv, C, hd) — and is updated IN PLACE:
`forward_with_cache` writes the new entries into the caller's cache and
returns that same object.

Which path a layer takes goes by shape and weights: a t=1 step with a
cache (the decode step) attends through K1 decode attention, and its int8
weights stream through K2 `qmm` (wq/wk/wv/wo) and K3 `fused_mlp` (the MLP);
the wrappers launch the CUDA kernels on the card and run their plain
versions on the CPU. Dense weights take `maybe_matmul` in every step, as
the JAX package leaves its decode matmuls to XLA (kalle_tpu/models/lm/
llama.py:236-243): the route is chosen here, at the call site, and a
kernel wrapper raises on what its kernel cannot take. Prefill (t>1) uses
`mha_t` and `maybe_matmul` in plain PyTorch. The JAX gate that keeps small
batches and int8 KV caches off its decode kernel was measured on a TPU;
here every t=1 step takes K1.

The training forward (`forward`) attends through K5-K7
(`ops/kernels/flash_attention.py`, forward and backward) when flash is on
and t % 128 == 0, else through `mha` with the causal padding mask. f32
master weights are cast to cfg.dtype where they are used, so their
gradients land in f32.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ...core.config import LlamaConfig, torch_dtype
from ...ops.attention import make_causal_padding_mask, mha, mha_t
from ...ops.kernels.decode_attention import decode_attention_cached
from ...ops.kernels.flash_attention import flash_attention
from ...ops.kernels.qmm import fused_mlp, qmm
from ...ops.quant import is_quantized, maybe_matmul


@dataclass
class KVCache:
    """Layer-stacked KV cache with a static max_len; `length` valid slots.
    int8 mode (cfg.kv_cache_dtype == "int8"): k/v hold int8 with per-(token,
    kv-head) absmax scales (L, b, nkv, 1, max_len) f32."""

    k: torch.Tensor  # (L, b, nkv, hd, max_len) — transposed keys
    v: torch.Tensor  # (L, b, nkv, max_len, hd)
    length: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[-1]

    @staticmethod
    def zeros(cfg: LlamaConfig, batch: int, max_len: int, device="cuda") -> "KVCache":
        nkv, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        int8 = cfg.kv_cache_dtype == "int8"
        dtype = torch.int8 if int8 else torch_dtype(cfg.dtype)

        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        def scale():
            return z(L, batch, nkv, 1, max_len, dt=torch.float32) if int8 else None

        return KVCache(k=z(L, batch, nkv, hd, max_len), v=z(L, batch, nkv, max_len, hd),
                       k_scale=scale(), v_scale=scale())


def _quantize_kv(x: torch.Tensor):
    """x (b, t, nkv, hd) -> (int8 same shape, scale (b, t, nkv, 1) f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


# ---------------------------------------------------------------------------
# RoPE (llama3 frequency scaling) and RMSNorm
# ---------------------------------------------------------------------------

def rope_inv_freq(cfg: LlamaConfig, device="cpu") -> torch.Tensor:
    dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    rs = cfg.rope_scaling
    if rs is None:
        return inv_freq
    low_wl = rs.original_max_position_embeddings / rs.low_freq_factor
    high_wl = rs.original_max_position_embeddings / rs.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (rs.original_max_position_embeddings / wavelen - rs.low_freq_factor) / (
        rs.high_freq_factor - rs.low_freq_factor)
    smoothed = (1.0 - smooth) * inv_freq / rs.factor + smooth * inv_freq
    out = torch.where(wavelen > low_wl, inv_freq / rs.factor, inv_freq)
    is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
    return torch.where(is_mid, smoothed, out)


def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (t,) or (b, t) -> cos/sin of shape positions.shape + (hd,)."""
    freqs = positions[..., None].float() * rope_inv_freq(cfg, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, t, h, d); cos/sin (t, d) or (b, t, d); HF rotate-half layout."""
    cos = cos[None, :, None, :] if cos.dim() == 2 else cos[:, :, None, :]
    sin = sin[None, :, None, :] if sin.dim() == 2 else sin[:, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, reduced in f32 — one PyTorch op
    (eight in a hand-written formula, and the decode step runs 32 a step).
    In bf16 it rounds once at the end where the JAX package rounds before
    the scale too: at most one bf16 ulp apart; in f32 identical."""
    return F.rms_norm(x, (x.shape[-1],), scale.to(x.dtype), eps)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random init (normal * 0.02, norms ones) with layers stacked on axis 0,
    in cfg.param_dtype."""
    pdt = torch_dtype(cfg.param_dtype)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    nq, nkv, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(pdt)

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=device)

    return {
        "embed": normal(cfg.vocab_size, h),
        "layers": {
            "attn_norm": ones(L, h),
            "wq": normal(L, h, nq * hd),
            "wk": normal(L, h, nkv * hd),
            "wv": normal(L, h, nkv * hd),
            "wo": normal(L, nq * hd, h),
            "mlp_norm": ones(L, h),
            "wg": normal(L, h, ffn),
            "wu": normal(L, h, ffn),
            "wd": normal(L, ffn, h),
        },
        "final_norm": ones(h),
    }


def layer_params(layers: dict) -> List[dict]:
    """The stacked layer params as one dict of views per layer (no copy;
    one unbind a weight rather than one index op a weight and layer)."""
    def split(w):
        if is_quantized(w):
            return [{"q": q, "scale": s}
                    for q, s in zip(w["q"].unbind(0), w["scale"].unbind(0))]
        return w.unbind(0)

    cols = {k: split(w) for k, w in layers.items()}
    return [dict(zip(cols, per_layer)) for per_layer in zip(*cols.values())]


def embed_tokens(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"][input_ids].to(torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w, decode: bool) -> torch.Tensor:
    """x (..., in) @ w: the decode step streams int8 weights through K2."""
    if not (decode and is_quantized(w)):
        return maybe_matmul(x, w)
    return qmm(x.reshape(-1, x.shape[-1]), w["q"], w["scale"]).reshape(
        *x.shape[:-1], w["q"].shape[-1])


def _mlp(x: torch.Tensor, lp: dict, decode: bool) -> torch.Tensor:
    """SwiGLU MLP of x (..., h): the decode step streams int8 weights
    through K3."""
    if decode and is_quantized(lp["wg"]):
        return fused_mlp(x.reshape(-1, x.shape[-1]), lp["wg"], lp["wu"],
                         lp["wd"]).reshape(x.shape)
    gate = F.silu(maybe_matmul(x, lp["wg"]))
    return maybe_matmul(gate * maybe_matmul(x, lp["wu"]), lp["wd"])


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: dict, cos, sin, mask,
           cache: Optional[KVCache] = None, li: int = 0,
           flash_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer block. Without a cache it attends over its own
    (b, t) keys: through the flash kernels when `flash_pad` (b, t) is
    given, else with `mha` and mask (b, 1, t, kv) bool. With a cache it
    writes its K/V at slots [cache.length, cache.length + t) of layer `li`
    and attends over that layer of the cache."""
    dt = x.dtype
    b, t, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    decode = t == 1 and cache is not None

    attn_in = rms_norm(x, lp["attn_norm"].to(dt), cfg.rms_norm_eps)
    q = apply_rope(_proj(attn_in, lp["wq"], decode).reshape(b, t, nq, hd), cos, sin)
    k = apply_rope(_proj(attn_in, lp["wk"], decode).reshape(b, t, nkv, hd), cos, sin)
    v = _proj(attn_in, lp["wv"], decode).reshape(b, t, nkv, hd)

    if cache is None:
        attn = (flash_attention(q, k, v, flash_pad) if flash_pad is not None
                else mha(q, k, v, mask))
    else:
        s0 = cache.length
        if s0 + t > cache.max_len:
            raise ValueError(f"cache of {cache.max_len} slots cannot take "
                             f"{t} more after {s0}")
        if cache.k_scale is not None:
            k, ks = _quantize_kv(k)
            v, vs = _quantize_kv(v)
            cache.k_scale[li, ..., s0:s0 + t] = ks.permute(0, 2, 3, 1)
            cache.v_scale[li, ..., s0:s0 + t] = vs.permute(0, 2, 3, 1)
        cache.k[li, ..., s0:s0 + t] = k.permute(0, 2, 3, 1).to(cache.k.dtype)
        cache.v[li, :, :, s0:s0 + t] = v.permute(0, 2, 1, 3).to(cache.v.dtype)
        if decode:
            attn = decode_attention_cached(q[:, 0], cache.k, cache.v, li,
                                           mask[:, 0, 0], cache.k_scale,
                                           cache.v_scale)[:, None]
        else:
            kt_l, vt_l = cache.k[li], cache.v[li]
            if cache.k_scale is not None:
                kt_l = (kt_l.float() * cache.k_scale[li]).to(dt)
                vt_l = (vt_l.float() * cache.v_scale[li].transpose(-1, -2)).to(dt)
            attn = mha_t(q, kt_l, vt_l, mask)

    x = x + _proj(attn.reshape(b, t, nq * hd), lp["wo"], decode)
    return x + _mlp(rms_norm(x, lp["mlp_norm"].to(dt), cfg.rms_norm_eps), lp, decode)


def forward_with_cache(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # (b, t, h)
    cache: KVCache,
    attention_mask: Optional[torch.Tensor] = None,  # (b, max_len) over cache
    positions: Optional[torch.Tensor] = None,  # (b, t) RoPE positions
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill/decode forward. Writes K/V at [cache.length, cache.length+t)
    (in place) and attends over the whole static cache with
    position-validity masking. `positions` overrides the default RoPE
    positions (per-row local positions for left-padded prompts)."""
    dt = torch_dtype(cfg.dtype)
    x = inputs_embeds.to(dt)
    b, t, _ = x.shape
    dev = x.device
    slots = cache.length + torch.arange(t, device=dev)
    if positions is None:
        positions = slots[None, :].expand(b, t)
    cos, sin = rope_cos_sin(cfg, positions)

    k_pos = torch.arange(cache.max_len, device=dev)[None, :]
    valid = k_pos < cache.length + t
    valid = valid & attention_mask.bool() if attention_mask is not None \
        else valid.expand(b, -1)
    causal = k_pos[None] <= slots[None, :, None]  # (1, t, max_len)
    mask = (causal & valid[:, None, :])[:, None]   # (b, 1, t, max_len)

    for li, lp in enumerate(layer_params(params["layers"])):
        x = _layer(cfg, x, lp, cos, sin, mask, cache, li)
    cache.length += t
    return rms_norm(x, params["final_norm"].to(dt), cfg.rms_norm_eps), cache


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """remat_policy "dots": keep the matmul outputs, recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: LlamaConfig):
    if cfg.remat_policy == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.noop_context_fn  # "full": recompute the whole layer


def forward(params: dict, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, use_flash: Optional[bool] = None
            ) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (b, t, h).

    use_flash: None follows cfg.use_flash_attention on the card and is off
    on the CPU; True on the CPU runs the kernels' plain versions. Flash
    needs t % 128 == 0 (every length bucket is a multiple of 128). With
    cfg.remat each layer is a non-reentrant `torch.utils.checkpoint`."""
    dt = torch_dtype(cfg.dtype)
    x = inputs_embeds.to(dt)
    t = x.shape[1]
    cos, sin = rope_cos_sin(cfg, torch.arange(t, device=x.device))
    if use_flash is None:
        use_flash = cfg.use_flash_attention and x.is_cuda
    flash_pad = attention_mask if use_flash and t % 128 == 0 else None
    mask = None if flash_pad is not None else make_causal_padding_mask(attention_mask, t)
    body = functools.partial(_layer, cfg, cos=cos, sin=sin, mask=mask, flash_pad=flash_pad)
    for lp in layer_params(params["layers"]):
        if cfg.remat:
            x = ckpt.checkpoint(body, x, lp, use_reentrant=False,
                                context_fn=_remat_context(cfg))
        else:
            x = body(x, lp)
    return rms_norm(x, params["final_norm"].to(dt), cfg.rms_norm_eps)
