"""Web helpers the HTTP server needs (copy of `wav_chunk_header` and
`normalize_text` from kalle_tpu/serve/web.py:25-42; the gradio demo is not
ported)."""
from __future__ import annotations

import struct


def wav_chunk_header(sample_rate: int = 24000, bits: int = 16,
                     channels: int = 1, data_size: int = 0x7FFFFFFF - 36) -> bytes:
    """Streaming WAV header with an (effectively) unbounded data size, so a
    browser starts playback before synthesis finishes."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + data_size), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, block_align, bits),
        b"data", struct.pack("<I", data_size),
    ])


def normalize_text(text: str) -> str:
    """Collapse runs of whitespace and strip the ends."""
    return " ".join(text.strip().split())
