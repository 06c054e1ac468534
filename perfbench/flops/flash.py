"""K5 flash forward, K6 / K7 flash backward over one microbatch of one
layer: rows of valid lengths `lengths` padded to `t`, causal, nq query and
nkv key/value heads of size hd, bf16. Operations are the causal pairs of
valid positions: 2 matmuls forward (QK^T, PV), 4 backward (dP, dV, dQ,
dK), 2 * hd operations a pair each."""
from __future__ import annotations

from typing import Sequence


def pairs(lengths: Sequence[int]) -> int:
    return sum(n * (n + 1) // 2 for n in lengths)


def flops_fwd(lengths, nq: int, hd: int) -> float:
    return 4.0 * nq * hd * pairs(lengths)


def flops_bwd(lengths, nq: int, hd: int) -> float:
    return 8.0 * nq * hd * pairs(lengths)


def bytes_fwd(b: int, t: int, nq: int, nkv: int, hd: int) -> float:
    """q, k, v and the pad mask read; o and the log-sum-exp written."""
    return 2 * b * t * (nq + 2 * nkv) * hd + 4 * b * t + 2 * b * t * nq * hd + 4 * b * nq * t


def bytes_bwd(b: int, t: int, nq: int, nkv: int, hd: int) -> float:
    """q, k, v, o, dO, the mask and the log-sum-exp read; dq, dk, dv
    written."""
    reads = 2 * b * t * (3 * nq + 2 * nkv) * hd + 4 * b * t + 4 * b * nq * t
    return reads + 2 * b * t * (nq + 2 * nkv) * hd
