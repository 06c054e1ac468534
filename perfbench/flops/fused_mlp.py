"""K3 `fused_mlp`: y (M, h) bf16 = (silu(x wg) * (x wu)) wd, int8 weights
with per-column f32 scales, x bf16."""
from __future__ import annotations


def flops(m: int, h: int, f: int) -> float:
    return 2.0 * m * h * f * 3


def nbytes(m: int, h: int, f: int) -> float:
    return 3 * h * f + 4 * (2 * f + h) + 2 * m * h + 2 * m * h
