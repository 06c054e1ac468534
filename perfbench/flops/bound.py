"""The least time the card could take for a piece of work: the larger of
its operations over the bf16 peak and its bytes over the HBM bandwidth."""
from __future__ import annotations

from ..common import H100_BF16_FLOP_PER_S, H100_HBM_BYTES_PER_S


def seconds(flops: float, nbytes: float) -> float:
    return max(flops / H100_BF16_FLOP_PER_S, nbytes / H100_HBM_BYTES_PER_S)
