"""Where K1's time goes: `csrc/decode_attention.cu` built with parts of its
tensor-core kernel (`tc::decode_mma`) taken out, each timed on the card,
and K1 beside its plain version and SDPA at the small batches of B4.

    python -m kalle_tpu_torch.ops.kernels.decode_probe [--against DIR]

Variants (text cuts, built as `qmm_probe` builds its own; the cut
variants only time, their outputs are not right): the kernel as it is;
walking every tile (no skip of the tiles that hold no valid column); one
block a row (cluster size 1: no split, no merge over the cluster); no
tensor-core work (no ldmatrix, movmatrix or mma.sync); one ring stage a
warp where the plan gives two; the loads alone (each warp's ring is
filled and waited on, nothing is computed); no tile work (every warp's
share empty: the mask, the merges and the stores, no K/V byte); the
launch alone (every block returns at once). With
`--against DIR`, also K1 as another checkout DIR (an earlier commit's `git
archive`, say) builds it from its `kalle_tpu_torch/csrc/decode_attention.cu`.

Shapes: chip_smoke.py phase 2's, 16 layers of bf16 cache (hd 64, 32 query
and 8 KV heads), the calls walking the layers so each finds its layer cold
in L2: batch 32 at cache 256 with the main path's last-step mask (32
prompt slots, 0-7 left-padded, then 128 frames), the same fully valid,
the sideband mode at cache 384 with serving's masks at batch 32 and 8,
and a long cache (batch 1, 4,096 slots, all valid: the one shape here
whose warps get several tiles each, so two ring stages a warp). Each
timed as 64 calls in a CUDA graph, one replay over CUDA events.

B4: K1, its plain version and SDPA (`enable_gqa`, a boolean mask) at batch
1, 2, 4 and 8 on the bench cache of 256 (the last-step mask), and the
int8-cache instance (the first port's kernel) with its plain version.

Prints the card (name, power limit) first, each shape's cluster size and
bound (the valid slots' K and V, q, out and mask over 3.35 TB/s), and the
host's time to launch the kernel as it is (and as DIR builds it) through
its C entry point; raises if an edit of the source makes a cut stop
applying.
"""
from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path

import torch

from . import _build
from .decode_attention import (_SIGS, decode_attention_cached, decode_attention_plain,
                               decode_attention_plan)
from .qmm_probe import build_variants, card, graph_ms

L, NQ, NKV, HD = 16, 32, 8, 64
TEXT_SLOTS, FRAMES = 32, 128
HBM_BYTES_PER_S = 3.35e12

CUTS = {
    "walk every tile": [(
        "  const bool all = n == 0 && !(side && new_valid[b]);  // no valid key: walk every tile",
        "  const bool all = true;")],
    "cluster size 1": [(
        "  while (S < MAXS && clusters * S < 3 * num_sms() && 2 * S * WARPS <= ntiles) S *= 2;",
        "")],
    "no tensor-core work": [
        ("      uint32_t a[4];\n"
         "      ldsm_x4_t(a, Ks + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * TL::KLD + mc * 16 +\n"
         "                       ((lane >> 3) & 1) * 8);\n"
         "      mma_bf16(s[mc], a, qf[kk]);\n", ""),
        ("    const uint32_t bp[2] = {movmatrix_t(pack_bf16(p[0], p[1])),\n"
         "                            movmatrix_t(pack_bf16(p[2], p[3]))};\n"
         "#pragma unroll\n"
         "    for (int md = 0; md < HD / 16; ++md) {\n"
         "      uint32_t a[4];\n"
         "      ldsm_x4_t(a, Vs + (mc * 16 + (lane >> 4) * 8 + (lane & 7)) * TL::VLD + md * 16 +\n"
         "                       ((lane >> 3) & 1) * 8);\n"
         "      mma_bf16(oacc[md], a, bp);\n"
         "    }\n", "")],
    "one stage": [(
        "  const int nst =\n"
        "      per_warp >= 2 && clusters <= active_clusters<HD, 2>(S, smem_bytes<HD>(S, C, 2)) ? 2 : 1;",
        "  const int nst = 1;")],
    "the loads alone": [(
        "    attend_tile<HD>(st, qf, cbits[t], t * TC, C, scale, m, l, oacc, lane);\n", "")],
    "no tile work": [(
        "  const int n_w = first < hi ? (hi - first + WARPS - 1) / WARPS : 0;",
        "  const int n_w = 0;")],
    "the launch alone": [(
        "  cg::cluster_group cluster = cg::this_cluster();\n  // this block has started",
        "  if (C > 0) return;\n  cg::cluster_group cluster = cg::this_cluster();\n"
        "  // this block has started")],
}


def host_us(fn, calls: int = 200) -> float:
    """Host time of one launch: `calls` calls back to back on the host
    clock, the device drained before and after (the launch queue holds
    them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def last_step_mask(g, b: int, c: int) -> torch.Tensor:
    """The main path's last decode step (chip_smoke phase 2): 32 prompt
    slots, the first 0-7 left-padded, then 128 frames."""
    n_pad = torch.randint(0, 8, (b,), generator=g, device="cuda")
    pos = torch.arange(c, device="cuda")[None]
    return (pos >= n_pad[:, None]) & (pos < TEXT_SLOTS + FRAMES)


def serving_mask(g, b: int, c: int):
    """A serving step (chip_smoke phase 5's shapes): a prompt of 20..bucket
    ids left-padded into a bucket of 32, 64 or 128 slots, then 0-127
    frames; about a quarter of the rows do not count this step's column."""
    bucket = torch.tensor((32, 64, 128), device="cuda")[
        torch.randint(0, 3, (b,), generator=g, device="cuda")]
    n_ids = 20 + (torch.rand(b, generator=g, device="cuda") * (bucket - 19)).long()
    n_gen = torch.randint(0, FRAMES, (b,), generator=g, device="cuda")
    pos = torch.arange(c, device="cuda")[None]
    mask = (((pos >= (bucket - n_ids)[:, None]) & (pos < bucket[:, None]))
            | ((pos >= bucket[:, None]) & (pos < (bucket + n_gen)[:, None])))
    return mask, torch.rand(b, generator=g, device="cuda") > 0.25


def edge_case_mask(b: int, c: int, device="cuda"):
    """(B, C) mask and (B,) new_valid, row i taking case i % 6: 0 a masked
    leading tile (valid from column 40 to 3/4 of C, every 5th dropped),
    new column counted; 1 a valid range inside one block's share (24
    columns ending 8 before C), new column not counted; 2 no valid column
    and the new column not counted (no valid key: V averaged uniformly);
    3 left-pad holes (valid [5, 160) but every 7th), new column not
    counted; 4 every column valid, new column counted; 5 no valid column,
    the new column counted (the output is v_new)."""
    pos = torch.arange(c, device=device)
    rows = [(pos >= 40) & (pos < 3 * c // 4) & (pos % 5 != 0),
            (pos >= c - 32) & (pos < c - 8),
            torch.zeros(c, dtype=torch.bool, device=device),
            (pos >= 5) & (pos < min(160, c)) & (pos % 7 != 0),
            torch.ones(c, dtype=torch.bool, device=device),
            torch.zeros(c, dtype=torch.bool, device=device)]
    live = torch.tensor([True, False, False, False, True, True], device=device)
    idx = torch.arange(b, device=device) % 6
    return torch.stack(rows)[idx], live[idx]


def bound_ms(mask, new_valid=None, int8: bool = False) -> float:
    """The valid slots' K and V (and the counted new columns; int8 with
    their two f32 scales), q, out, the mask and new_valid, over the card's
    memory rate."""
    b, c = mask.shape
    keys = int(mask.sum()) + (0 if new_valid is None else int(new_valid.sum()))
    per_key = NKV * (HD * 2 + 2 * 4) if int8 else NKV * HD * 2 * 2
    nbytes = keys * per_key + 2 * b * NQ * HD * 2 + b * c + (0 if new_valid is None else b)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _cache(g, b: int, c: int):
    q = torch.randn(L, b, NQ, HD, generator=g, device="cuda").to(torch.bfloat16)
    kt = torch.randn(L, b, NKV, HD, c, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(L, b, NKV, c, HD, generator=g, device="cuda").to(torch.bfloat16)
    kn, vn = (torch.randn(L, b, NKV, HD, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    return q, kt, v, kn, vn


def probe_parts(g, libs: dict) -> None:
    for what, b, c, side in (("last step", 32, 256, False), ("fully valid", 32, 256, False),
                             ("serving", 32, 384, True), ("serving", 8, 384, True),
                             ("fully valid", 1, 4096, False)):
        q, kt, v, kn, vn = _cache(g, b, c)
        if side:
            mask, live = serving_mask(g, b, c)
        else:
            mask, live = last_step_mask(g, b, c), None
            if what == "fully valid":
                mask = torch.ones_like(mask)
        out = torch.empty_like(q[0])
        layers = itertools.count()
        row, host = [], []
        for variant, lib in libs.items():
            def call(lib=lib):
                i = next(layers) % L
                lay = lambda t: t.data_ptr() + i * t.stride(0) * t.element_size()  # noqa: E731
                rc = lib.kt_decode_attention(
                    q[i].data_ptr(), lay(kt), lay(v), mask.data_ptr(), None, None,
                    kn[i].data_ptr() if side else None, vn[i].data_ptr() if side else None,
                    live.data_ptr() if side else None, out.data_ptr(), b, NKV, NQ // NKV, HD,
                    c, 1, 0, _build.stream())
                if rc:
                    raise RuntimeError(f"decode_probe {variant}: CUDA error {rc}")
            row.append(f"{variant} {graph_ms(call) * 1e3:.2f}")
            if variant.endswith("as it is"):
                host.append(f"{variant} {host_us(call):.2f}")
        plan = decode_attention_plan(b, NKV, NQ // NKV, HD, c)
        print(f"K1 {what}{' sideband' if side else ''} B={b} C={c} (cluster "
              f"{plan['cluster']}, {plan['stages']} stage(s), {int(mask.sum())} valid slots, bound "
              f"{bound_ms(mask, live) * 1e3:.2f}) us: " + "; ".join(row), flush=True)
        print("  host us a call (the C entry point through ctypes, no sync): " + "; ".join(host),
              flush=True)
        del q, kt, v, kn, vn
        torch.cuda.empty_cache()


def probe_small_batches(g) -> None:
    """B4: every t=1 step goes through K1; its time beside the plain
    version's and SDPA's at batch 1-8, and the int8 cache's instance."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    c = 256  # the bench cache: 32 ids and 128 frames, rounded up to 128
    for b in (1, 2, 4, 8):
        q, kt, v, _, _ = _cache(g, b, c)
        mask = last_step_mask(g, b, c)
        am = mask[:, None, None, :]
        ks = kt.float().abs().amax(3, keepdim=True).clamp_min(1e-8) / 127
        vs = v.float().abs().amax(4, keepdim=True).clamp_min(1e-8) / 127
        kq = torch.round(kt.float() / ks).to(torch.int8)
        vq = torch.round(v.float() / vs).to(torch.int8)
        vs = vs.transpose(-1, -2).contiguous()

        def timed(fn):
            layers = itertools.count()
            return graph_ms(lambda: fn(next(layers) % L)) * 1e3

        k_us = timed(lambda i: decode_attention_cached(q[i], kt, v, i, mask))
        p_us = timed(lambda i: decode_attention_plain(q[i], kt, v, i, mask))
        s_us = timed(lambda i: sdpa(q[i][:, :, None], kt[i].transpose(-1, -2), v[i],
                                    attn_mask=am, enable_gqa=True))
        k8_us = timed(lambda i: decode_attention_cached(q[i], kq, vq, i, mask, ks, vs))
        p8_us = timed(lambda i: decode_attention_plain(q[i], kq, vq, i, mask, ks, vs))
        plan = decode_attention_plan(b, NKV, NQ // NKV, HD, c)
        b_us, b8_us = bound_ms(mask) * 1e3, bound_ms(mask, int8=True) * 1e3
        print(f"B4 B={b} C={c} (cluster {plan['cluster']}, {int(mask.sum())} valid slots) us: "
              f"kernel {k_us:.2f}; plain {p_us:.2f}; sdpa {s_us:.2f}; bound {b_us:.2f}; "
              f"int8 cache kernel {k8_us:.2f}; int8 plain {p8_us:.2f}; int8 bound "
              f"{b8_us:.2f}", flush=True)
        del q, kt, v, kq, vq
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="also time K1 as the checkout DIR builds it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_probe: needs a CUDA card")
    print(f"card {card()}", flush=True)
    others = ({f"{args.against} as it is":
               Path(args.against) / "kalle_tpu_torch/csrc/decode_attention.cu"}
              if args.against else None)
    libs = build_variants("decode_attention.cu", CUTS,
                          {"kt_decode_attention": _SIGS["kt_decode_attention"]}, "k1", others)
    g = torch.Generator(device="cuda").manual_seed(0)
    tiny = torch.zeros(1, device="cuda")
    print(f"launch floor (one tiny op) us {graph_ms(lambda: tiny.add_(1)) * 1e3:.2f}")
    probe_parts(g, libs)
    probe_small_batches(g)


if __name__ == "__main__":
    main()
