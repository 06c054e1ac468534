"""Tensor-parallel shard shapes on one card: every tp rank's halves of a layer
through the kernels, their partials summed in place of the all-reduce and
held against the unsharded layer.

    python -m kalle_tpu_torch.parallel.tp_probe [--tp 2 4 8]

At each tp size, for each rank r (no process group: the ranks run one
after another on the card):
  * decode (int8 layer weights, bf16, a KV cache of n_kv/tp heads):
    K2 on the column shards of wq/wk/wv and the row shard of wo, K1 on the
    rank's heads, K3 on the wg/wu column shards and the wd row shard, each
    held against its plain version; then the rank's `attention_block` and
    `mlp_block`, separate and in the fused layout (each rank's parts fused
    after sharding), with their launches counted exactly;
  * training: one layer's attention (dense bf16 weights, flash K5-K7 at
    n_q/tp heads) forward and backward, K5-K7 held against their plain
    versions at the rank's shapes.
The sums over r of the block outputs, of the training block's input
gradients (what f's all-reduce adds up) and the rank's weight gradients
against the unsharded block's columns or rows, through the same kernels,
must agree at bf16 tolerance (2e-2 of the largest magnitude). Raises on a
disagreement; returns the largest errors. Runs where its generator is (the
card; the launch counts need the kernels).
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from ..core.config import LlamaConfig
from ..models.lm import llama
from ..ops.kernels import _build
from ..ops.kernels import decode_attention as k1
from ..ops.kernels import flash_attention as fa
from ..ops.kernels import qmm as k23
from ..ops.quant import fuse_decode_params, quantize_weight
from .mesh import TP_AXIS, leaf_specs, shard_leaf

TOL = 2e-2
KERNEL_TOL = {"qmm": 1e-2, "fused_mlp": 1e-2, "decode_attention": 2e-2, "flash": 2e-2}


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _check(what: str, got, ref, tol: float, errs: Dict[str, float]) -> None:
    e = _rel(got, ref)
    errs[what] = max(errs.get(what, 0.0), e)
    if not e <= tol:
        raise AssertionError(f"{what}: relative error {e:.4g} > {tol}")


def _counted(fn, expect: Dict[str, int], what: str):
    before = _build.launches()
    out = fn()
    got = {k: v - before.get(k, 0) for k, v in _build.launches().items()}
    got = {k: v for k, v in got.items() if v}
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, the path implies {expect}")
    return out


def _shards(layer: Dict[str, torch.Tensor], tp: int) -> list:
    """Each tp rank's shards of one layer (a stacked L = 1 tree through the
    layout table), the L axis taken off again."""
    stacked = {"layers": {k: ({"q": w["q"][None], "scale": w["scale"][None]}
                              if isinstance(w, dict) else w[None]) for k, w in layer.items()}}
    specs = leaf_specs(stacked, {TP_AXIS: tp})["layers"]
    out = []
    for r in range(tp):
        def cut(w, s):
            return shard_leaf(w, s, {TP_AXIS: tp}, {TP_AXIS: r})[0]

        out.append({k: ({"q": cut(w["q"], specs[k]["q"]), "scale": cut(w["scale"],
                                                                          specs[k]["scale"])}
                        if isinstance(w, dict) else cut(w, specs[k]))
                    for k, w in stacked["layers"].items()})
    return out


def check(cfg: LlamaConfig, tp: int, batch: int, cache_len: int, train_batch: int,
          train_t: int, g: torch.Generator, log=print) -> Dict[str, float]:
    """The decode and training checks at one tp size (module docstring)."""
    H, F, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    if nkv % tp:
        raise ValueError(f"tp={tp} does not divide {nkv} KV heads")
    dev, bf = g.device, torch.bfloat16
    errs: Dict[str, float] = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    shapes = {"wq": (H, nq * hd), "wk": (H, nkv * hd), "wv": (H, nkv * hd),
              "wo": (nq * hd, H), "wg": (H, F), "wu": (H, F), "wd": (F, H)}
    dense = {k: randn(*s, scale=0.02) for k, s in shapes.items()}

    # ---- decode: int8 weights, a cache of `batch` rows filled to s0 slots
    layer = {k: quantize_weight(w) for k, w in dense.items()}
    ranks = _shards(layer, tp)
    s0 = cache_len - 2 * batch // 8 - 1
    n_pad = torch.randint(0, 8, (batch,), generator=g, device=dev)
    slot = torch.arange(cache_len, device=dev)[None]
    valid = (slot >= n_pad[:, None]) & (slot <= s0)
    mask = valid[:, None, None, :]
    cos, sin = llama.rope_cos_sin(cfg, (s0 - n_pad)[:, None])
    k_full = torch.zeros(1, batch, nkv, hd, cache_len, device=dev, dtype=bf)
    v_full = torch.zeros(1, batch, nkv, cache_len, hd, device=dev, dtype=bf)
    k_full[..., :s0] = randn(1, batch, nkv, hd, s0).to(bf)
    v_full[..., :s0, :] = randn(1, batch, nkv, s0, hd).to(bf)
    h = randn(batch, 1, H).to(bf)
    h2 = randn(batch, 1, H).to(bf)
    x2d = h.reshape(batch, H)

    def cache(heads=slice(None)):
        return llama.KVCache(k=k_full[:, :, heads].clone(), v=v_full[:, :, heads].clone(),
                             length=s0)

    ref_attn = llama.attention_block(cfg, h, layer, cos, sin, mask, cache(), 0)
    ref_mlp = llama.mlp_block(h2, layer, True)
    sums = {}
    for r, lp in enumerate(ranks):
        heads = slice(r * nkv // tp, (r + 1) * nkv // tp)
        for name in ("wq", "wk", "wv", "wo"):
            xin = x2d if name != "wo" else randn(batch, lp["wo"]["q"].shape[0]).to(bf)
            _check("qmm", k23.qmm(xin, lp[name]["q"], lp[name]["scale"]),
                   k23.qmm_plain(xin, lp[name]["q"], lp[name]["scale"]),
                   KERNEL_TOL["qmm"], errs)
        _check("fused_mlp", k23.fused_mlp(x2d, lp["wg"], lp["wu"], lp["wd"]),
               k23.fused_mlp_plain(x2d, lp["wg"], lp["wu"], lp["wd"]),
               KERNEL_TOL["fused_mlp"], errs)
        c = cache(heads)
        q = randn(batch, nq // tp, hd).to(bf)
        _check("decode_attention", k1.decode_attention_cached(q, c.k, c.v, 0, valid),
               k1.decode_attention_plain(q, c.k, c.v, 0, valid),
               KERNEL_TOL["decode_attention"], errs)
        fused = fuse_decode_params({"layers": {k: {"q": w["q"][None], "scale": w["scale"][None]}
                                               for k, w in lp.items()}})["layers"]
        fused = {k: {"q": w["q"][0], "scale": w["scale"][0]} for k, w in fused.items()}
        wqkv = fused["wqkv"]
        _check("qmm", k23.qmm(x2d, wqkv["q"], wqkv["scale"]),
               k23.qmm_plain(x2d, wqkv["q"], wqkv["scale"]), KERNEL_TOL["qmm"], errs)
        gu = k23.fused_mlp(x2d, fused["wgu"], None, lp["wd"])
        if not torch.equal(gu, k23.fused_mlp(x2d, lp["wg"], lp["wu"], lp["wd"])):
            raise AssertionError(f"tp={tp} rank {r}: K3's fused mode differs from the unfused")
        for tag, w, n_qmm, mlp_name in (("", lp, 4, k23.NAME_MLP),
                                        (" fused", fused, 2, k23.NAME_MLP_GU)):
            a = _counted(lambda: llama.attention_block(cfg, h, w, cos, sin, mask, cache(heads),
                                                       0),
                         {k23.NAME_QMM: n_qmm, k1.NAME: 1}, f"tp={tp} attention{tag}")
            m = _counted(lambda: llama.mlp_block(h2, w, True), {mlp_name: 1},
                         f"tp={tp} mlp{tag}")
            sums["attn" + tag] = sums.get("attn" + tag, 0) + a.float()
            sums["mlp" + tag] = sums.get("mlp" + tag, 0) + m.float()
    for tag in ("", " fused"):
        _check("attention partials", sums["attn" + tag], ref_attn, TOL, errs)
        _check("mlp partials", sums["mlp" + tag], ref_mlp, TOL, errs)

    # ---- training: one layer's attention forward and backward through K5-K7
    wts = {k: dense[k].to(bf) for k in ("wq", "wk", "wv", "wo")}
    tranks = _shards(wts, tp)
    ht = randn(train_batch, train_t, H).to(bf)
    dy = randn(train_batch, train_t, H).to(bf)
    lens = torch.randint(train_t // 2, train_t + 1, (train_batch,), generator=g, device=dev)
    pad = (torch.arange(train_t, device=dev)[None] < lens[:, None]).to(torch.int32)
    tcos, tsin = llama.rope_cos_sin(cfg, torch.arange(train_t, device=dev))

    def block(w):
        w = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        x = ht.detach().requires_grad_(True)
        out = llama.attention_block(cfg, x, w, tcos, tsin, None, flash_pad=pad)
        (out.float() * dy.float()).sum().backward()
        return out.detach(), x.grad, {k: v.grad for k, v in w.items()}

    ref_out, ref_dx, ref_dw = block(wts)
    out_sum, dx_sum = 0, 0
    for r, w in enumerate(tranks):
        q = randn(train_batch, train_t, nq // tp, hd).to(bf)
        kk = randn(train_batch, train_t, nkv // tp, hd).to(bf)
        vv = randn(train_batch, train_t, nkv // tp, hd).to(bf)
        do = randn(train_batch, train_t, nq // tp, hd).to(bf)
        o, lse = fa.flash_fwd(q, kk, vv, pad)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, kk, vv, pad)
        _check("flash_fwd", o, o_ref, KERNEL_TOL["flash"], errs)
        delta = fa.attention_delta(o_ref, do)
        _check("flash_bwd_dq", fa.flash_bwd_dq(q, kk, vv, pad, do, lse_ref, delta),
               fa.flash_bwd_dq_plain(q, kk, vv, pad, do, lse_ref, delta),
               KERNEL_TOL["flash"], errs)
        for got, ref in zip(fa.flash_bwd_dkv(q, kk, vv, pad, do, lse_ref, delta),
                            fa.flash_bwd_dkv_plain(q, kk, vv, pad, do, lse_ref, delta)):
            _check("flash_bwd_dkv", got, ref, KERNEL_TOL["flash"], errs)
        out, dx, dw = _counted(lambda: block(w), {fa.NAME_FWD: 1, fa.NAME_DQ: 1,
                                                   fa.NAME_DKV: 1}, f"tp={tp} train attention")
        out_sum, dx_sum = out_sum + out.float(), dx_sum + dx.float()
        cols = slice(r * shapes["wq"][1] // tp, (r + 1) * shapes["wq"][1] // tp)
        _check("train dwq shard", dw["wq"], ref_dw["wq"][:, cols], TOL, errs)
        _check("train dwo shard", dw["wo"], ref_dw["wo"][cols], TOL, errs)
    _check("train attention partials", out_sum, ref_out, TOL, errs)
    _check("train input grads", dx_sum, ref_dx, TOL, errs)
    log(f"  tp={tp}: KV heads {nkv // tp}, query heads {nq // tp}, FFN {F // tp}; relative "
        "errors " + " ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def main(argv=None) -> int:
    from ..core.config import LlamaConfig as Cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args(argv)
    cfg = Cfg(dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(10)
    for tp in args.tp:
        check(cfg, tp, batch=32, cache_len=384, train_batch=8, train_t=512, g=g)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
