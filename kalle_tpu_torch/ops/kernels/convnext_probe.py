"""Where K4's time goes: `csrc/convnext_block.cu` built with parts of the
tensor-core instances taken out, each timed on the card at the SigmaVAE
decoder's five block shapes (batch 32, 128 frames: C 512 / T 128, 512 /
1,024, 256 / 5,120, 128 / 25,600, 64 / 102,400).

    python -m kalle_tpu_torch.ops.kernels.convnext_probe

Variants (text cuts, built as `qmm_probe` builds its own; their outputs
are not right): the kernel as it is; without gelu_tanh (a = v * g);
without the depthwise conv (h left as it was); without the tensor-core
work (no mma.sync, and so none of the GELU and A fragments that only feed
it). Each timed as a CUDA graph's replay of several calls, over CUDA
events. Prints the card (name, power limit) first; raises if a cut stops
applying to the source.
"""
from __future__ import annotations

import torch

from . import _build
from .convnext_block import _SIGS, K
from .qmm_probe import build_variants, card, graph_ms

SHAPES = ((512, 128), (512, 1024), (256, 5120), (128, 25600), (64, 102400))
BATCH = 32
CUTS = {
    "no gelu": [("          va[i][e] = v * gelu_tanh_approx(g);",
                 "          va[i][e] = v * g;")],
    "no conv": [("      for (int rb = 0; rb < RS; rb += KW) {",
                 "      for (int rb = 0; rb < 0; rb += KW) {")],
    "no tensor-core work": [
        ("            mma_pair(va[i], va[i + 1], a, bw);\n", ""),
        ("            mma_pair(ga[i], ga[i + 1], a, bw);\n", ""),
        ("            mma_pair(oacc[dd * (K::DC / 8) + j], oacc[dd * (K::DC / 8) + j + 1], a, "
         "bw);\n", "")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("convnext_probe: needs a CUDA card")
    print(f"card {card()}", flush=True)
    libs = build_variants("convnext_block.cu", CUTS, _SIGS, "k4")
    g = torch.Generator(device="cuda").manual_seed(0)
    for c, t in SHAPES:
        h = 2 * c

        def u(*shape, bound=1.0):
            return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                    * bound).to(torch.bfloat16)

        args = (u(c) + 1, u(K, 1, c, bound=K ** -0.5), u(c, bound=K ** -0.5),
                u(1, c, 2 * h, bound=c ** -0.5), u(2 * h, bound=c ** -0.5),
                u(1, h, c, bound=h ** -0.5), u(c, bound=h ** -0.5))
        x = torch.randn(BATCH, t, c, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty_like(x)
        row = []
        for variant, lib in libs.items():
            def call(lib=lib):
                rc = lib.kt_convnext_block(x.data_ptr(), *(a.data_ptr() for a in args),
                                           out.data_ptr(), BATCH, t, c, h, 1e-6,
                                           _build.stream())
                if rc:
                    raise RuntimeError(f"convnext_probe {variant}: CUDA error {rc}")
            row.append(f"{variant} {graph_ms(call, 20 if t <= 5120 else 5):.4f}")
        print(f"K4 C={c} T={t} ms: " + "; ".join(row), flush=True)
        del x, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
