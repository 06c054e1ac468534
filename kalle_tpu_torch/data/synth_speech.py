"""Tone-coded synthetic "speech": a deterministic text<->audio language
(copy of kalle_tpu/data/synth_speech.py, numpy only; renders bit-equal).

The reference's acceptance metrics are WER via real ASR and speaker-sim via
a trained WavLM-ECAPA (ref tools/asr_test.py:28-45, tools/sim_test.py:23-26).
No such checkpoint ships with the project, so this module defines a synthetic spoken language in which they
become mechanically measurable END TO END:

  * every character maps to a fixed pair of "formant" frequencies, rendered
    as ~80 ms tones — so text is genuinely recoverable from audio by an
    acoustic model (the CTC ASR of eval/ctc_asr.py), and
    WER flows through the real scorer (eval/wer.py);
  * a speaker id maps to an f0 + spectral-tilt + formant-scale profile —
    so speaker identity is genuinely present in the waveform and a trained
    ECAPA separates same-speaker from cross-speaker pairs by construction.

Audio here is an eval fixture, not a claim about natural speech: the point
is that the transcribe->score pipeline runs on real model outputs with a
real acoustic front-end rather than latent-space proxies.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

VOCAB = "abcdefghijklmnopqrstuvwxyz "  # index 0.. ; CTC blank sits at 0 in the model
CHAR_SECONDS = 0.08
CROSSFADE = 0.008


# 2-D formant code (a vowel-chart analog): 5 F1 x 6 F2 grid covers the 27
# characters. Spacing is MULTIPLICATIVE and wider than the speaker
# formant_scale range (+-6%), so a speaker's common-mode formant shift can
# never alias one character into another (F1 ratio steps 35%, F2 steps 18%,
# both > 2x the speaker scale) — the property that makes the code learnable
# across speakers.
_F1 = tuple(420.0 * 1.35 ** k for k in range(5))    # 420 .. 1395 Hz
_F2 = tuple(2300.0 * 1.18 ** k for k in range(6))   # 2300 .. 5262 Hz


def char_formants(c: str) -> Tuple[float, float]:
    i = VOCAB.index(c)
    return _F1[i % 5], _F2[i // 5]


def speaker_profile(spk: int) -> dict:
    """Deterministic per-speaker acoustics: f0 (pitch), formant scale
    (vocal-tract length analog), spectral tilt, vibrato rate."""
    rng = np.random.default_rng(1000 + spk)
    return {
        "f0": float(85.0 * (1.13 ** (spk % 8)) * (1 + 0.03 * rng.standard_normal())),
        "formant_scale": float(1.0 + 0.03 * ((spk % 5) - 2)),
        "tilt": float(0.5 + 0.12 * (spk % 4)),
        "vibrato_hz": float(4.0 + (spk % 3)),
    }


def render(text: str, sr: int, speaker: int = 0, seed: int = 0,
           char_seconds: float = CHAR_SECONDS,
           freq_scale: float = 0.0) -> np.ndarray:
    """text -> float32 waveform (T,). Each char: two formant tones scaled by
    the speaker's formant_scale, amplitude-modulated at the speaker's f0
    (voicing), plus an f0 fundamental carrying speaker identity; spaces are
    low-energy breath noise. Small per-utterance jitter (duration, phase,
    noise) keeps renders non-identical across seeds.

    ``freq_scale`` scales every frequency (f0, F1, F2) so the code fits
    under low Nyquist rates (tiny-codec smoke runs at 2 kHz); 0.0 = auto
    (min(1, sr/16000) — the full code needs ~5.6 kHz of bandwidth)."""
    if freq_scale <= 0.0:
        freq_scale = min(1.0, sr / 16000.0)
    prof = dict(speaker_profile(speaker))
    prof["f0"] *= freq_scale
    rng = np.random.default_rng([seed, speaker, len(text)])
    segs: List[np.ndarray] = []
    nfade = int(CROSSFADE * sr)
    for ci, c in enumerate(text):
        if c not in VOCAB:
            c = " "
        dur = char_seconds * (1.0 + 0.15 * rng.standard_normal())
        n = max(int(dur * sr), 2 * nfade + 8)
        t = np.arange(n) / sr
        if c == " ":
            seg = 0.04 * rng.standard_normal(n)
        else:
            f1, f2 = char_formants(c)
            f1 *= prof["formant_scale"] * freq_scale
            f2 *= prof["formant_scale"] * freq_scale
            vib = 1.0 + 0.01 * np.sin(2 * np.pi * prof["vibrato_hz"] * t)
            ph1, ph2, ph0 = rng.uniform(0, 2 * np.pi, 3)
            voicing = 0.55 + 0.45 * np.sin(2 * np.pi * prof["f0"] * vib * t + ph0)
            seg = voicing * (
                np.sin(2 * np.pi * f1 * t + ph1)
                + prof["tilt"] * np.sin(2 * np.pi * f2 * t + ph2))
            # fundamental: speaker identity audible independent of text
            seg = seg + 0.35 * np.sin(2 * np.pi * prof["f0"] * vib * t)
            seg = seg + 0.02 * rng.standard_normal(n)
        env = np.ones(n)
        env[:nfade] = np.linspace(0, 1, nfade)
        env[-nfade:] = np.linspace(1, 0, nfade)
        segs.append((seg * env).astype(np.float32))
    wav = np.concatenate(segs) if segs else np.zeros(8, np.float32)
    peak = np.abs(wav).max() + 1e-9
    return (0.8 * wav / peak).astype(np.float32)


def random_sentence(rng: np.random.Generator, n_words: Tuple[int, int] = (2, 5),
                    word_len: Tuple[int, int] = (2, 6)) -> str:
    words = []
    for _ in range(int(rng.integers(*n_words))):
        k = int(rng.integers(*word_len))
        words.append("".join(VOCAB[i] for i in rng.integers(0, 26, k)))
    return " ".join(words)


def encode_text(text: str) -> np.ndarray:
    """text -> int labels (1-based; 0 is the CTC blank)."""
    return np.array([VOCAB.index(c) + 1 for c in text if c in VOCAB],
                    dtype=np.int32)


def decode_labels(labels) -> str:
    return "".join(VOCAB[int(i) - 1] for i in labels if int(i) > 0)
