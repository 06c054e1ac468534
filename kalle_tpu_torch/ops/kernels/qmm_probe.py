"""Where K2's time goes: `csrc/qmm.cu` built with parts of the `qmm`
kernel taken out, each timed per projection on the card.

    python -m kalle_tpu_torch.ops.kernels.qmm_probe

Variants (text cuts of the source, built with `_build.NVCC_FLAGS` into
`build/kernels/probe/`): the kernel as it is; without its tensor-core work
(no A fragments, no mma.sync); without its cluster reduction (the
barriers kept, no stores to other ranks, each owner reads its own block's
sums); without both (copies, barriers and epilogue left). Each runs on
int8 wq (2048 x 2048), wk (2048 x 512) and wo at M 8 and 32, beside
`torch.matmul` on the pre-dequantized bf16 weight and one tiny PyTorch op
(the launch floor), each timed as 64 calls captured in a CUDA graph, one
replay over CUDA events; the calls walk 16 layers' weights in turn, so
each finds its weight cold in L2, as in a decode step. The cut variants
only time: their outputs are not right. Prints the card (name, power
limit) first.
"""
from __future__ import annotations

import ctypes
import itertools
import subprocess

import torch

from . import _build

CUTS = {
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
CUTS["neither"] = CUTS["no tensor-core work"] + CUTS["no cluster reduction"]
SHAPES = {"wq": (2048, 2048), "wk": (2048, 512), "wo": (2048, 2048)}
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


def build_variants() -> dict:
    src = (_build.CSRC / "qmm.cu").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ["as it is", *CUTS]:
        text = src
        for old, new in CUTS.get(name, []):
            if old not in text:
                raise RuntimeError(f"qmm_probe: csrc/qmm.cu changed, cut for {name!r} "
                                   "no longer applies")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace("-", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                                         str(_build.CSRC), "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"qmm_probe: nvcc failed for {name!r}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.kt_qmm.argtypes = [_build.P] * 4 + [_build.I] * 5 + [_build.P]
        lib.kt_qmm.restype = _build.I
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qmm_probe: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    weights = {}
    for name, (k, n) in SHAPES.items():
        w = torch.randn(LAYERS, k, n, generator=g, device="cuda") * 0.02
        s = w.abs().amax(1, keepdim=True).clamp_min(1e-8) / 127
        q = torch.round(w / s).to(torch.int8)
        weights[name] = (q, s[:, 0].contiguous(), (q.float() * s).to(torch.bfloat16))
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
            print(f"M={m} {name} us: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
