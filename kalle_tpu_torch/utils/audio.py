"""Host-side audio I/O (copy of kalle_tpu/utils/audio.py), numpy and the
stdlib only.

Audio is written peak-normalized to int16, as the reference does
(`audio / max|audio|`, clamped to [-1, 1], times 32767) before it saves
a wav. Reading falls back to soundfile, imported only then, for formats
the stdlib `wave` module cannot parse.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def normalize_int16(audio: np.ndarray) -> np.ndarray:
    """(C, T) float -> int16, peak-normalized."""
    audio = np.asarray(audio, np.float32)
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              normalize: bool = True) -> None:
    """audio: (T,) or (C, T), float in [-1, 1] or int16."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.dtype != np.int16:
        audio = normalize_int16(audio) if normalize else (
            np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(audio.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(audio.T.reshape(-1).tobytes())


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> ((C, T) float32 in [-1, 1], sample_rate). PCM wav through the
    stdlib; other formats through soundfile where it is installed."""
    try:
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            n = f.getnframes()
            ch = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(n)
        if width == 2:
            data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        return data.reshape(-1, ch).T.copy(), sr
    except (wave.Error, EOFError):
        import soundfile as sf  # optional, for non-PCM formats

        data, sr = sf.read(path, dtype="float32", always_2d=True)
        return data.T.copy(), sr


def resample_linear(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler for host-side prep, (C, T) -> (C, T')
    with T' = round(T * sr_out / sr_in)."""
    if sr_in == sr_out:
        return audio
    t_out = int(round(audio.shape[-1] * sr_out / sr_in))
    x_old = np.linspace(0.0, 1.0, audio.shape[-1], endpoint=False)
    x_new = np.linspace(0.0, 1.0, t_out, endpoint=False)
    return np.stack([np.interp(x_new, x_old, ch) for ch in audio]).astype(
        np.float32)
