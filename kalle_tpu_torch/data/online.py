"""Online-encoding dataset: raw audio -> codec latents at load time (port
of kalle_tpu/data/online.py).

Rows of HF parquet (`audio.bytes`, `text_normalized`, `id`) or jsonl: the
host decodes and peak-normalizes the audio; `OnlineEncoder.encode_batch`
encodes a batch of it through the frozen codec on the codec's device (the
reference encodes item by item in CPU dataloader workers). pandas
(parquet) and an ffmpeg subprocess (non-WAV audio) are used only when a
call needs them.
"""
from __future__ import annotations

import io
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.audio import read_wav, resample_linear
from .collate import Item
from .datasets import vae_sample
from .tokens import build_prompt_ids


def read_parquet(paths):
    """Parquet shards -> one concatenated pandas frame."""
    import pandas as pd

    if isinstance(paths, str):
        paths = [paths]
    return pd.concat([pd.read_parquet(p) for p in paths], ignore_index=True)


def _decode_via_ffmpeg(data: bytes, target_sr: int) -> np.ndarray:
    """Audio bytes in any container ffmpeg reads -> (1, T) float32 mono at
    target_sr, through an ffmpeg subprocess."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("non-WAV audio and neither soundfile nor ffmpeg available")
    proc = subprocess.run(
        [ffmpeg, "-v", "error", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
         "-ar", str(target_sr), "pipe:1"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(f"ffmpeg decode failed: {proc.stderr.decode(errors='replace')[:500]}")
    return np.frombuffer(proc.stdout, np.float32).copy()[None, :]


def decode_audio_bytes(data: bytes, target_sr: int) -> np.ndarray:
    """Audio bytes -> (1, T) float32 mono at target_sr: soundfile when it is
    installed, else the stdlib WAV reader for RIFF bytes, else ffmpeg."""
    try:
        import soundfile as sf

        wav, sr = sf.read(io.BytesIO(data), dtype="float32", always_2d=True)
        wav = wav.T
    except Exception:  # no soundfile, or a format it cannot read
        if data[:4] != b"RIFF":
            return _decode_via_ffmpeg(data, target_sr)  # already resampled
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            wav, sr = read_wav(path)
        finally:
            os.unlink(path)
    return resample_linear(wav.mean(axis=0, keepdims=True), sr, target_sr)


def normalize_peak(wav: np.ndarray, gain: float = 0.95) -> np.ndarray:
    """wav / max|wav| * gain (librosa.util.normalize * 0.95)."""
    peak = np.abs(wav).max()
    return (wav / peak * gain).astype(np.float32) if peak > 0 else wav


class OnlineEncoder:
    """Batched codec encoding for the online dataset path."""

    def __init__(self, codec, sample_rate: Optional[int] = None,
                 fake_stereo: Optional[bool] = None):
        self.codec = codec  # infer.pipeline.Codec
        self.sample_rate = sample_rate or codec.sample_rate
        # the Oobleck path duplicates mono to fake stereo, as the reference
        self.fake_stereo = codec.kind == "stableaudio" if fake_stereo is None else fake_stereo

    def encode_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """(1, T) mono float32 wavs at the codec's rate -> channel-first
        (C, T') host arrays, encoded as one right-zero-padded batch on the
        codec's device and trimmed back to max(T // ratio, 1) frames each.
        C = 2*latent (mean||scale) for stableaudio and melvae, latent (the
        means) for sigma."""
        ratio = getattr(self.codec.cfg, "downsampling_ratio",
                        getattr(self.codec.cfg, "hop", 1))
        lens = [w.shape[-1] for w in wavs]
        pad_to = max(-(-max(lens) // ratio) * ratio, ratio)
        batch = np.zeros((len(wavs), 2 if self.fake_stereo else 1, pad_to), np.float32)
        for i, w in enumerate(wavs):
            batch[i, :, :lens[i]] = np.repeat(w, 2, axis=0) if self.fake_stereo else w
        z = self.codec.encode_audio(torch.from_numpy(batch))
        if self.codec.kind == "sigma":  # sigma encodes (B, T', d)
            z = np.transpose(z, (0, 2, 1))
        return [z[i, :, :max(n // ratio, 1)] for i, n in enumerate(lens)]


class OnlineAudioDataset:
    """Rows with raw audio -> Items with freshly encoded latents: the
    reference's text packing and vae_sample semantics, the encode done by
    `OnlineEncoder` over a batch of rows."""

    def __init__(self, rows, tokenizer, encoder: OnlineEncoder,
                 text_key: str = "text_normalized", audio_key: str = "audio", seed: int = 0,
                 max_length: int = 2048):
        self.rows = rows
        self.tokenizer = tokenizer
        self.encoder = encoder
        self.text_key = text_key
        self.audio_key = audio_key
        self.rng = np.random.default_rng(seed)
        self.max_length = max_length

    def __len__(self):
        return len(self.rows)

    def _row(self, idx):
        return self.rows.iloc[idx] if hasattr(self.rows, "iloc") else self.rows[idx]

    def load_audio(self, idx: int) -> np.ndarray:
        audio = self._row(idx)[self.audio_key]
        data = audio["bytes"] if isinstance(audio, dict) else audio
        return normalize_peak(decode_audio_bytes(data, self.encoder.sample_rate))

    def make_items(self, idxs: Sequence[int]) -> List[Item]:
        """Decode on the host, encode as one batch, pack Items. Sigma's
        labels are its means (the model adds the noise); the other codecs'
        latents are drawn from mean||scale with the dataset's numpy
        generator."""
        stacks = self.encoder.encode_batch([self.load_audio(i) for i in idxs])
        items = []
        for i, z in zip(idxs, stacks):
            row = self._row(i)
            text = str(row[self.text_key])
            ids = np.asarray(build_prompt_ids(self.tokenizer, text), np.int32)
            if self.encoder.codec.kind == "sigma":
                lat_td = z.T.astype(np.float32)
                dist_td = lat_td.copy()
            else:
                d2 = z.shape[0]
                lat, _ = vae_sample(z[None, : d2 // 2], z[None, d2 // 2:], self.rng)
                lat_td = lat[0].T.astype(np.float32)
                dist_td = z.T.astype(np.float32)
            items.append(Item(input_ids=ids, audio_latents=lat_td, audio_distribution=dist_td,
                              raw_text=text,
                              speech_path=str(row.get("id", i)) if hasattr(row, "get") else str(i)))
        return items
