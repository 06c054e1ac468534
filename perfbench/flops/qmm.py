"""K2 `qmm`: y (M, N) bf16 = (x (M, K) bf16 @ q (K, N) int8) * scale (N,) f32."""
from __future__ import annotations


def flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def nbytes(m: int, k: int, n: int) -> float:
    return k * n + 4 * n + 2 * m * k + 2 * m * n


def decode_projections(s: dict):
    """(K, N) of the four projections a decode layer streams through K2
    (wq, wk, wv, wo), in launch order."""
    h, q, kv = s["hidden"], s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    return [(h, q), (h, kv), (h, kv), (q, h)]
