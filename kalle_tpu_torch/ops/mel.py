"""STFT magnitude and mel spectrogram as products with the DFT bases (port
of kalle_tpu/ops/mel.py).

The reference's torchaudio MelSpectrogram operating point by default:
16 kHz, n_fft 1024, window 1024, hop 256, 80 mels, power 1, 0-8 kHz,
Slaney mel scale and Slaney norm. The STFT reflect-pads the centre, takes
frames by index and multiplies them by the periodic-Hann-windowed cos and
-sin bases, as the JAX package does (no complex FFT): the same sums, so
the two meet at f32 rounding. The bases and the filterbank are numpy,
built once and moved to the input's device at each call.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window's default (periodic)."""
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * t / n)).astype(np.float32)


def hz_to_mel_slaney(f):
    """The Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: Optional[float] = None, norm: str = "slaney") -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank, Slaney scale and norm (as
    torchaudio.functional.melscale_fbanks(mel_scale='slaney'))."""
    f_max = f_max or sample_rate / 2
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min, m_max = hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz_slaney(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_freqs) cos and -sin bases with the window (centred in the
    frame, as torch pads it to n_fft) folded in."""
    n_freqs = n_fft // 2 + 1
    ang = 2 * np.pi * np.outer(np.arange(n_fft), np.arange(n_freqs)) / n_fft
    w = np.zeros(n_fft, np.float32)
    off = (n_fft - win_length) // 2
    w[off:off + win_length] = hann_window(win_length)
    return ((np.cos(ang) * w[:, None]).astype(np.float32),
            (-np.sin(ang) * w[:, None]).astype(np.float32))


def stft_mag(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
             win_length: Optional[int] = None, center: bool = True,
             power: float = 1.0) -> torch.Tensor:
    """audio (..., T) -> magnitude (power 1) or power (power 2)
    spectrogram (..., n_freqs, frames)."""
    win_length = win_length or n_fft
    if center:
        pad = n_fft // 2
        lead = audio.shape[:-1]
        audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad),
                      mode="reflect").reshape(*lead, -1)
    n_frames = 1 + (audio.shape[-1] - n_fft) // hop_length
    frames = audio.unfold(-1, n_fft, hop_length)[..., :n_frames, :]  # (..., frames, n_fft)
    cos_b, sin_b = (torch.from_numpy(b).to(audio.device, audio.dtype)
                    for b in _dft_bases(n_fft, win_length))
    re, im = frames @ cos_b, frames @ sin_b
    mag2 = re * re + im * im
    spec = torch.sqrt(mag2.clamp_min(1e-12)) if power == 1.0 else mag2
    return spec.transpose(-1, -2)


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16000, n_fft: int = 1024,
                    hop_length: int = 256, win_length: int = 1024, n_mels: int = 80,
                    f_min: float = 0.0, f_max: float = 8000.0,
                    power: float = 1.0) -> torch.Tensor:
    """audio (..., T) -> (..., n_mels, frames)."""
    spec = stft_mag(audio, n_fft, hop_length, win_length, power=power)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min,
                                         f_max)).to(spec.device, spec.dtype)
    return (spec.transpose(-1, -2) @ fb).transpose(-1, -2)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(max(x, clip_val))."""
    return torch.log(x.clamp_min(clip_val))


def modify_vector(mel: torch.Tensor, target_frames: int = 200) -> torch.Tensor:
    """Crop or tile mel (..., n_mels, T) to exactly `target_frames` (the
    ECAPA input's length)."""
    t = mel.shape[-1]
    if t >= target_frames:
        return mel[..., :target_frames]
    reps = -(-target_frames // t)
    return mel.repeat(*(1,) * (mel.dim() - 1), reps)[..., :target_frames]
