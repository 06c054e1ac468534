"""Llama-3.2 decoder backbone (port of kalle_tpu/models/lm/llama.py:28-159,
200-403 and 406-459): the KV-cached inference forward and the
full-sequence training forward.

Params keep the JAX layout: a dict whose `layers` entry stacks the L
transformer layers on a leading axis, matmul weights (in, out), optionally
int8 or int4 {'q','scale'} dicts (ops/quant.py), optionally in the fused
decode layout (`wqkv`, `wgu`: ops.quant.fuse_decode_params).

The KV cache keeps the JAX package's layout too — keys transposed per head
(L, b, nkv, hd, C), values (L, b, nkv, C, hd) — and is updated IN PLACE:
`forward_with_cache` writes the new entries into the caller's cache and
returns that same object.

Which path a layer takes goes by shape and weights: a t=1 step with a
cache (the decode step) attends through K1 decode attention, and its
per-channel int8 weights stream through K2 `qmm` (wq/wk/wv/wo, or the
fused wqkv in one launch, split into q/k/v after) and K3 `fused_mlp` (the
MLP; the fused wgu in K3's fused mode); the wrappers launch the CUDA
kernels on the card and run their plain versions on the CPU. Dense
weights take `maybe_matmul` in every step, as the JAX package leaves its
decode matmuls to XLA (kalle_tpu/models/lm/llama.py:236-256), and so do
group-wise (int4) weights, whose matmul the JAX package also leaves to
XLA (kalle_tpu/ops/quant.py:58-66): the route is chosen here, at the call
site, by the weights' structure and their scale's rank, and a kernel
wrapper raises on what its kernel cannot take. Prefill (t>1) uses
`mha_t` and `maybe_matmul` in plain PyTorch. The JAX gate that keeps small
batches and int8 KV caches off its decode kernel was measured on a TPU;
here every t=1 step takes K1.

The training forward (`forward`) attends through K5-K7
(`ops/kernels/flash_attention.py`, forward and backward) when flash is on
and t % 128 == 0, else through `mha` with the causal padding mask. f32
master weights are cast to cfg.dtype where they are used, so their
gradients land in f32.

Parallelism (parallel/, a `Layout` or a tp process group passed in):
  * tp, Megatron (port of kalle_tpu/models/lm/llama.py:200-267): a layer
    holds this rank's column shards of wq/wk/wv/wg/wu and row shards of
    wo/wd, so it runs n_q/tp query and n_kv/tp KV heads (counted from the
    shard shapes) and F/tp FFN columns through the same kernels. Each half
    of a layer (`attention_block`, `mlp_block`) returns its row-parallel
    partial; `_layer` feeds them the normed input through f and sums them
    through g (parallel/collectives.py). The KV cache holds n_kv/tp heads;
  * sp: between layers a rank holds its slice of t; q, k and v are
    all-gathered along t (backward: reduce-scatter), attention runs over
    the whole t and each rank keeps its own rows; RoPE positions are
    global;
  * fsdp: each layer's weights are all-gathered over dp at their use
    (`Layout.use_layer`), inside the remat region when cfg.remat;
  * pp: the stages' layers run as a GPipe pipeline (parallel/pipeline.py).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ...core.config import LlamaConfig, torch_dtype
from ...ops.attention import make_causal_padding_mask, mha, mha_t
from ...ops.kernels.decode_attention import decode_attention_cached
from ...ops.kernels.flash_attention import flash_attention
from ...ops.kernels.qmm import fused_mlp, qmm
from ...ops.quant import is_grouped, is_quantized, maybe_matmul
from ...parallel.collectives import all_gather, copy_to, reduce_from


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
    def zeros(cfg: LlamaConfig, batch: int, max_len: int, device="cuda",
              n_kv: Optional[int] = None) -> "KVCache":
        """n_kv: the KV heads this rank holds (n_kv / tp under tp)."""
        nkv, hd, L = n_kv or cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
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

def _streams(w, decode: bool) -> bool:
    """Whether this matmul goes through K2/K3: a decode step's per-channel
    int8 weight (dense and group-wise weights take `maybe_matmul`)."""
    return decode and is_quantized(w) and not is_grouped(w)


def _proj(x: torch.Tensor, w, decode: bool) -> torch.Tensor:
    """x (..., in) @ w: the decode step streams int8 weights through K2."""
    if not _streams(w, decode):
        return maybe_matmul(x, w)
    return qmm(x.reshape(-1, x.shape[-1]), w["q"], w["scale"]).reshape(
        *x.shape[:-1], w["q"].shape[-1])


def _cols(w) -> int:
    return (w["q"] if is_quantized(w) else w).shape[-1]


def local_heads(cfg: LlamaConfig, lp: dict) -> Tuple[int, int]:
    """(query heads, KV heads) of a layer's weights as this rank holds them:
    all of them, or n/tp each under tp."""
    hd, group = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    if "wqkv" in lp:  # q | k | v columns in the ratio group : 1 : 1
        cols = _cols(lp["wqkv"])
        nkv = cols // (hd * (group + 2))
        nq, whole = group * nkv, cols == (group + 2) * nkv * hd
    else:
        nq, nkv = _cols(lp["wq"]) // hd, _cols(lp["wk"]) // hd
        whole = (_cols(lp["wq"]), _cols(lp["wk"])) == (nq * hd, nkv * hd) and nq == group * nkv
    if not whole or nkv == 0:
        raise ValueError(f"a layer's q/k/v shards do not hold whole heads of {hd} in the "
                         f"ratio {cfg.num_heads}:{cfg.num_kv_heads} (tp must divide "
                         "num_kv_heads)")
    return nq, nkv


def _qkv(cfg: LlamaConfig, x: torch.Tensor, lp: dict, decode: bool):
    """The q (b, t, nq, hd), k and v (b, t, nkv, hd) projections of x (b,
    t, h), before RoPE, for the heads this rank holds: three matmuls, or
    one over the fused `wqkv` split into its q|k|v columns."""
    b, t, _ = x.shape
    nq, nkv = local_heads(cfg, lp)
    hd = cfg.head_dim
    if "wqkv" in lp:
        q, k, v = _proj(x, lp["wqkv"], decode).split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = (_proj(x, lp[n], decode) for n in ("wq", "wk", "wv"))
    return q.reshape(b, t, nq, hd), k.reshape(b, t, nkv, hd), v.reshape(b, t, nkv, hd)


def mlp_block(x: torch.Tensor, lp: dict, decode: bool) -> torch.Tensor:
    """SwiGLU MLP of the normed x (..., h) over this rank's FFN columns: the
    row-parallel partial under tp. The decode step streams int8 weights
    through K3 (the fused `wgu` in its fused mode)."""
    fused = "wgu" in lp
    wg = lp["wgu"] if fused else lp["wg"]
    if _streams(wg, decode):
        return fused_mlp(x.reshape(-1, x.shape[-1]), wg, None if fused else lp["wu"],
                         lp["wd"]).reshape(x.shape)
    if fused:
        g, up = maybe_matmul(x, wg).chunk(2, dim=-1)
    else:
        g, up = maybe_matmul(x, wg), maybe_matmul(x, lp["wu"])
    return maybe_matmul(F.silu(g) * up, lp["wd"])


def attention_block(cfg: LlamaConfig, h: torch.Tensor, lp: dict, cos, sin, mask,
                    cache: Optional[KVCache] = None, li: int = 0,
                    flash_pad: Optional[torch.Tensor] = None, sp=None) -> torch.Tensor:
    """Attention of the normed input h (b, t, hidden) over this rank's heads,
    through wo (its row shard under tp): the row-parallel partial.

    Without a cache it attends over its own (b, t) keys: through the flash
    kernels when `flash_pad` (b, t) is given, else with `mha` and mask (b,
    1, t, kv) bool. With a cache it writes its K/V at slots [cache.length,
    cache.length + t) of layer `li` and attends over that layer of the
    cache. With an sp group, h is this rank's slice of the sequence and
    `flash_pad` / `mask` cover the whole of it."""
    dt = h.dtype
    b, t, _ = h.shape
    hd = cfg.head_dim
    decode = t == 1 and cache is not None

    q, k, v = _qkv(cfg, h, lp, decode)
    nq = q.shape[2]
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if sp is not None:
        q, k, v = (all_gather(a, 1, sp) for a in (q, k, v))

    if cache is None:
        attn = (flash_attention(q, k, v, flash_pad) if flash_pad is not None
                else mha(q, k, v, mask))
        if sp is not None:  # this rank's rows
            attn = attn.narrow(1, dist.get_rank(sp) * t, t)
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
    return _proj(attn.reshape(b, t, nq * hd), lp["wo"], decode)


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: dict, cos, sin, mask,
           cache: Optional[KVCache] = None, li: int = 0,
           flash_pad: Optional[torch.Tensor] = None, tp=None, sp=None) -> torch.Tensor:
    """One transformer block (attention_block, then mlp_block, each on the
    normed residual). `tp`: the tensor-parallel group (f before each
    block, g after it) or None."""
    dt = x.dtype
    decode = x.shape[1] == 1 and cache is not None
    h = copy_to(rms_norm(x, lp["attn_norm"].to(dt), cfg.rms_norm_eps), tp)
    x = x + reduce_from(attention_block(cfg, h, lp, cos, sin, mask, cache, li, flash_pad, sp),
                        tp)
    h = copy_to(rms_norm(x, lp["mlp_norm"].to(dt), cfg.rms_norm_eps), tp)
    return x + reduce_from(mlp_block(h, lp, decode), tp)


def forward_with_cache(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # (b, t, h)
    cache: KVCache,
    attention_mask: Optional[torch.Tensor] = None,  # (b, max_len) over cache
    positions: Optional[torch.Tensor] = None,  # (b, t) RoPE positions
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill/decode forward. Writes K/V at [cache.length, cache.length+t)
    (in place) and attends over the whole static cache with
    position-validity masking. `positions` overrides the default RoPE
    positions (per-row local positions for left-padded prompts). `tp`: the
    tensor-parallel group of tp-sharded params (the cache then holds
    n_kv/tp heads) or None."""
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
        x = _layer(cfg, x, lp, cos, sin, mask, cache, li, tp=tp)
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


def _run_layers(cfg: LlamaConfig, x: torch.Tensor, layers: dict, body) -> torch.Tensor:
    """body(x, lp) over the stacked layers; with cfg.remat each layer is a
    non-reentrant `torch.utils.checkpoint`."""
    for lp in layer_params(layers):
        if cfg.remat:
            x = ckpt.checkpoint(body, x, lp, use_reentrant=False,
                                context_fn=_remat_context(cfg))
        else:
            x = body(x, lp)
    return x


def forward(params: dict, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, use_flash: Optional[bool] = None,
            layout=None) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (b, t, h).

    use_flash: None follows cfg.use_flash_attention on the card and is off
    on the CPU; True on the CPU runs the kernels' plain versions. Flash
    needs t % 128 == 0 (every length bucket is a multiple of 128). With
    cfg.remat each layer is a non-reentrant `torch.utils.checkpoint`.

    layout (parallel.mesh.Layout): params hold this rank's shards. Under sp
    the result is this rank's slice of t (`layout.seq_slice`); under pp
    the layers run as a GPipe pipeline and every stage gets the whole
    result."""
    dt = torch_dtype(cfg.dtype)
    x = inputs_embeds.to(dt)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device)
    if use_flash is None:
        use_flash = cfg.use_flash_attention and x.is_cuda
    flash_pad = attention_mask if use_flash and t % 128 == 0 else None
    mask = None if flash_pad is not None else make_causal_padding_mask(attention_mask, t)
    tp = sp = None
    if layout is not None:
        from ...parallel.mesh import PP_AXIS

        tp, sp = layout.tp, layout.sp
        if layout.mesh.size(PP_AXIS) > 1:
            x = _pipelined(cfg, x, params["layers"], mask, flash_pad, tp, layout)
            return rms_norm(x, params["final_norm"].to(dt), cfg.rms_norm_eps)
        if sp is not None:
            start, n = layout.seq_slice(t)
            x, positions = x[:, start:start + n], positions[start:start + n]
    cos, sin = rope_cos_sin(cfg, positions)

    def body(x, lp):
        if layout is not None:
            lp = layout.use_layer(lp)
        return _layer(cfg, x, lp, cos, sin, mask, flash_pad=flash_pad, tp=tp, sp=sp)

    x = _run_layers(cfg, x, params["layers"], body)
    return rms_norm(x, params["final_norm"].to(dt), cfg.rms_norm_eps)


def pipeline_stage(cfg: LlamaConfig, x: torch.Tensor, mask, flash_pad, tp, n_mb: int):
    """stage(h, stage_layers, m): a pipeline stage's layers (L / pp of the
    stack) on microbatch m of x's rows, with its rows of the masks."""
    mb = x.shape[0] // n_mb
    cos, sin = rope_cos_sin(cfg, torch.arange(x.shape[1], device=x.device))

    def stage(h, stage_layers, m):
        rows = slice(m * mb, (m + 1) * mb)
        body = functools.partial(
            _layer, cfg, cos=cos, sin=sin, mask=None if mask is None else mask[rows],
            flash_pad=None if flash_pad is None else flash_pad[rows], tp=tp)
        return _run_layers(cfg, h, stage_layers, body)

    return stage


def _pipelined(cfg: LlamaConfig, x, layers, mask, flash_pad, tp, layout):
    from ...parallel.mesh import PP_AXIS
    from ...parallel.pipeline import pipelined_layer_stack

    n_mb = cfg.pp_microbatches
    stage = pipeline_stage(cfg, x, mask, flash_pad, tp, n_mb)
    return pipelined_layer_stack(stage, layers, x, n_mb, layout.mesh.group(PP_AXIS))
