"""Where K2's and K3's time goes: `csrc/qmm.cu` built with parts of a
kernel taken out, each timed on the card.

    python -m kalle_tpu_torch.ops.kernels.qmm_probe [--against DIR]

Variants are text cuts of the source, built with `_build.NVCC_FLAGS` into
`build/kernels/probe/`; the cut variants only time, their outputs are not
right. Each call is timed as 64 calls captured in a CUDA graph, one replay
over CUDA events; the calls walk 16 layers' weights in turn, so each finds
its weight cold in L2, as in a decode step. Prints the card (name, power
limit) first, and raises if an edit of `csrc/qmm.cu` makes a cut stop
applying (update the cuts with it).

K2 `qmm`, per projection (int8 wq 2048 x 2048, wk 2048 x 512, wo) at M 8
and 32, beside `torch.matmul` on the pre-dequantized bf16 weight and one
tiny PyTorch op (the launch floor): the kernel as it is; without its
tensor-core work (no A fragments, no mma.sync); without its cluster
reduction (the barriers kept, no stores to other ranks, each owner reads
its own block's sums); without both.

K3 `fused_mlp` (int8 H 2048, F 8192) at M 8, 32 and 72, beside the composed
`torch.matmul` / `silu * u` / `torch.matmul` of chip_smoke.py: the kernel
as it is; without its tensor-core work (no widening, no mma.sync in
either phase); without the cross-cluster reduction (no partial sums
stored, no cluster-sum kernel); with one chunk of phase 2 (wd) instead of
all of them; and the weight stream alone (none of those, no x copies, no
phase boundary: the copying warps and the computing warps' barriers).
With `--against DIR`, also K3 as another checkout DIR (an earlier commit's
`git archive`, say) builds it from its `kalle_tpu_torch/csrc/qmm.cu`,
called through the same C entry point. Every variant gets x zero-padded
to a multiple of 16 rows (of 64 above 64 rows), which earlier versions
of the kernel read, and an f32 scratch of at least M x H; the padding is
made once, outside the timed calls.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
from pathlib import Path
from typing import Optional

import torch

from . import _build

K2_CUTS = {
    "no tensor-core work": [("        a_frags<S::WLD>(a, ws, k0, lane);\n",
                             "        continue;\n")],
    "no cluster reduction": [
        ("  for (int i = 4 * threadIdx.x; i < BN * mt; i += 4 * THREADS) {\n"
         "    const int m = i / BN, n = i % BN;\n"
         "    *reinterpret_cast<float4*>(cluster.map_shared_rank(inbox, i / share) + "
         "rank * share +\n"
         "                               i % share) =\n"
         "        *reinterpret_cast<const float4*>(red + ((n / 32) * KG * MP + m) * RLD "
         "+ n % 32);\n"
         "  }\n", ""),
        ("const float4 v = *reinterpret_cast<const float4*>(inbox + r * share + j);",
         "const float4 v = *reinterpret_cast<const float4*>(red + ((n / 32) * KG * MP + m) "
         "* RLD + n % 32);")],
}
K2_CUTS["neither"] = K2_CUTS["no tensor-core work"] + K2_CUTS["no cluster reduction"]

_K3_MMA = [
    ("        a_frags<K::WLD>(a, ws, s * 16, lane);\n"
     "        mma_rows<MT8>(acc, a, reinterpret_cast<const bf16*>(st), XLD, s * 16, lane);\n",
     "        continue;\n"),
    ("          a_frags<K::WLD2>(a, wt, s * 16, lane);\n"
     "          mma_rows<MT8>(acc, a, hs, hld, kc * K::CK2 + s * 16, lane);\n",
     "          continue;\n")]
_K3_REDUCTION = [
    ("        if (kc == kpc - 1) {  // its sums are complete",
     "        if (false) {  // its sums are complete"),
    ("  if (err != cudaSuccess) return (int)err;\n  sum_kernel", "  return (int)err;\n  sum_kernel")]
_K3_ONE_WD = [("const int nc1 = H / CK, nc = nc1 + (nr + K::CN2 - 1) / K::CN2 * kpc;",
               "const int nc1 = H / CK, nc = nc1 + 1;")]
_K3_NO_X = [("    copy_x_rows<K::MP, K::CT>(reinterpret_cast<bf16*>(st), x, M, H, m0, k, t);\n",
             "")]
_K3_NO_BOUNDARY = [("    if (c == nc1) {  // phase boundary", "    if (false) {  // phase boundary")]
K3_CUTS = {
    "no tensor-core work": _K3_MMA,
    "no cross-cluster reduction": _K3_REDUCTION,
    "one wd chunk": _K3_ONE_WD,
    "weight stream alone": _K3_MMA + _K3_REDUCTION + _K3_NO_X + _K3_NO_BOUNDARY,
}
SHAPES = {"wq": (2048, 2048), "wk": (2048, 512), "wo": (2048, 2048)}
H, F = 2048, 8192
LAYERS = 16


def graph_ms(fn, iters: int = 64) -> float:
    """Device time of one call: `iters` calls in a CUDA graph, one replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def build_variants(source: str, cuts: dict, signatures: dict, tag: str,
                   others: Optional[dict] = None) -> dict:
    """`csrc/<source>` as it is and with each entry of `cuts` (name ->
    [(old, new), ...]) applied, and each source file of `others` (name ->
    path, built beside its own headers), one nvcc each, all at once; the
    libraries with argtypes set from `signatures` (entry point ->
    argtypes) where they have the entry point."""
    src = (_build.CSRC / source).read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ["as it is", *cuts, *(others or {})]:
        text, inc = src, _build.CSRC
        if name in (others or {}):
            text, inc = Path(others[name]).read_text(), Path(others[name]).parent
        for old, new in cuts.get(name, []):
            if old not in text:
                raise RuntimeError(f"probe: csrc/{source} changed, cut for {name!r} "
                                   "no longer applies")
            text = text.replace(old, new)
        stem = f"{tag}_" + name.replace(" ", "_").replace("-", "_").replace("/", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                                         str(inc), "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe: nvcc failed for {name!r}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = _build.I
        libs[name] = lib
    return libs


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def int8_layers(g, k: int, n: int):
    """LAYERS int8 (k, n) weights, their per-column scales and the
    dequantized bf16 weights."""
    w = torch.randn(LAYERS, k, n, generator=g, device="cuda") * 0.02
    s = w.abs().amax(1, keepdim=True).clamp_min(1e-8) / 127
    q = torch.round(w / s).to(torch.int8)
    return q, s[:, 0].contiguous(), (q.float() * s).to(torch.bfloat16)


def probe_qmm(g) -> None:
    from .qmm import _SIGS

    libs = build_variants("qmm.cu", K2_CUTS, {"kt_qmm": _SIGS["kt_qmm"]}, "k2")
    weights = {name: int8_layers(g, k, n) for name, (k, n) in SHAPES.items()}
    tiny = torch.zeros(1, device="cuda")
    print(f"launch floor (one tiny op) us {graph_ms(lambda: tiny.add_(1)) * 1e3:.2f}")
    for m in (8, 32):
        x = torch.randn(m, 2048, generator=g, device="cuda").to(torch.bfloat16)
        for name, (q, s, deq) in weights.items():
            k, n = SHAPES[name]
            out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            layers = itertools.count()
            lib_ms = graph_ms(lambda: torch.matmul(x, deq[next(layers) % LAYERS]))
            row = [f"matmul {lib_ms * 1e3:.2f}"]
            for variant, lib in libs.items():
                def call(lib=lib):
                    i = next(layers) % LAYERS
                    rc = lib.kt_qmm(x.data_ptr(), q[i].data_ptr(), s[i].data_ptr(),
                                    out.data_ptr(), m, k, n, 1, 0, _build.stream())
                    if rc:
                        raise RuntimeError(f"qmm_probe {variant}: CUDA error {rc}")
                row.append(f"{variant} {graph_ms(call) * 1e3:.2f}")
            print(f"K2 M={m} {name} us: " + "; ".join(row), flush=True)


def probe_fused_mlp(g, against: Optional[str] = None) -> None:
    from torch.nn.functional import silu

    from .qmm import _SIGS, fused_mlp_plan

    others = {f"{against} as it is": Path(against) / "kalle_tpu_torch/csrc/qmm.cu"} \
        if against else None
    libs = build_variants("qmm.cu", K3_CUTS, {k: _SIGS[k] for k in _SIGS
                                             if k.startswith("kt_fused_mlp")}, "k3", others)
    # a checkout from before K3's fused mode takes no weight row stride
    unstrided = {name for name, path in (others or {}).items()
                 if "int ldw" not in Path(path).read_text()}
    for name in unstrided:
        libs[name].kt_fused_mlp.argtypes = [_build.P] * 9 + [_build.I] * 5 + [_build.P]
    (gq, gs, gd), (uq, us, ud), (dq, ds, dd) = (int8_layers(g, *s) for s in
                                                ((H, F), (H, F), (F, H)))
    gu = torch.cat([gd, ud], dim=2)
    del gd, ud
    for m in (8, 32, 72):
        x = torch.randn(m, H, generator=g, device="cuda").to(torch.bfloat16)
        tile = 16 if m <= 64 else 64
        xp = torch.zeros(-(-m // tile) * tile, H, device="cuda", dtype=torch.bfloat16)
        xp[:m] = x
        out = torch.empty(m, H, device="cuda", dtype=torch.bfloat16)
        layers = itertools.count()

        def composed():
            i = next(layers) % LAYERS
            a = torch.matmul(x, gu[i])
            return torch.matmul(silu(a[:, :F]) * a[:, F:], dd[i])

        row = [f"composed {graph_ms(composed) * 1e3:.2f}"]
        for variant, lib in libs.items():
            plan = (ctypes.c_int * 4)()
            if hasattr(lib, "kt_fused_mlp_plan") and lib.kt_fused_mlp_plan(m, H, F, 1, 0, plan):
                raise RuntimeError(f"qmm_probe {variant}: no plan")
            scratch = torch.empty(max(plan[0], m * H), device="cuda")

            dims = (m, H, F) if variant in unstrided else (m, H, F, F)

            def call(lib=lib, scratch=scratch, dims=dims):
                i = next(layers) % LAYERS
                rc = lib.kt_fused_mlp(xp.data_ptr(), gq[i].data_ptr(), gs[i].data_ptr(),
                                      uq[i].data_ptr(), us[i].data_ptr(), dq[i].data_ptr(),
                                      ds[i].data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                      *dims, 1, 0, _build.stream())
                if rc:
                    raise RuntimeError(f"qmm_probe {variant}: CUDA error {rc}")
            row.append(f"{variant} {graph_ms(call) * 1e3:.2f}")
        plan = fused_mlp_plan(m, H, F)
        print(f"K3 M={m} (int8 {H} x {F}; {plan['clusters']} clusters of "
              f"{plan['cluster']}, {plan['stages']} stages) us: " + "; ".join(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="also time K3 as the checkout DIR builds it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qmm_probe: needs a CUDA card")
    print(f"card {card()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    probe_qmm(g)
    probe_fused_mlp(g, args.against)


if __name__ == "__main__":
    main()
