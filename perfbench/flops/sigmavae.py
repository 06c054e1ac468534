"""Model operations of a SigmaVAE decode: the convolutions' products."""
from __future__ import annotations


def decode_flops(c: dict, batch: int, frames: int) -> float:
    """Decoding `frames` latent frames of `batch` rows."""
    chs, strides, k = c["channels"], c["strides"], c["kernel"]
    t = frames
    total = 2.0 * t * c["latent_dim"] * chs[-1]  # pointwise input conv
    for i in reversed(range(len(strides))):
        cin = chs[i + 1] if i + 1 < len(chs) else chs[-1]
        hid = c["mlp_ratio"] * cin
        per_block = 2.0 * t * (k * cin + cin * 2 * hid + hid * cin)
        total += c["blocks_per_stage"] * per_block
        s = strides[i]
        total += 2.0 * (t * s) * cin * chs[i] * 2  # transposed conv, kernel 2s, stride s
        t *= s
    total += 2.0 * t * chs[0] * k  # the output conv
    return batch * total
