"""Streaming-interleave collation, text and audio in lockstep with a delay
(port of kalle_tpu/data/streaming.py).

Each wav is zero-padded at the FRONT by delay_frames of samples, the
batch is encoded through the frozen codec (`OnlineEncoder`) to a
mean||logs stack, input latents are the sampled z shifted [:, :, :-1] and
labels the stack [:, :, 1:]; text ids are padded with the pad token to
T_latent - 1; the speaker mel (ECAPA's input) is cropped or tiled to 200
frames; rows drop their speaker condition with probability
spk_drop_prob. The mels come from ops/mel.py on the host's CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.mel import mel_spectrogram, modify_vector


class StreamingCollator:
    def __init__(self, encoder, tokenizer, delay_frames: int, frame_hz: float,
                 spk_drop_prob: float = 0.0, mel_sample_rate: int = 16000, seed: int = 0):
        self.encoder = encoder  # data.online.OnlineEncoder
        self.tokenizer = tokenizer
        self.delay_frames = delay_frames
        self.frame_hz = frame_hz
        self.spk_drop_prob = spk_drop_prob
        self.mel_sample_rate = mel_sample_rate
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: List[Dict]) -> Optional[Dict[str, np.ndarray]]:
        """batch items: {"input_ids": (s,) int, "wav": (1, T) float at the
        codec's rate, "mel_wav": optional (1, T16k) float for the speaker
        mel}. None when the latents are not longer than the text (the
        reference asserts it)."""
        b = len(batch)
        delay_n = int(self.delay_frames * (self.encoder.sample_rate // self.frame_hz))
        final = int(max(it["wav"].shape[-1] for it in batch) + delay_n)
        wavs = []
        for it in batch:
            w = np.zeros((1, final), np.float32)
            w[0, delay_n: delay_n + it["wav"].shape[-1]] = it["wav"][0]
            wavs.append(w)
        stacks = self.encoder.encode_batch(wavs)  # (2d, T') each
        t_lat = min(s.shape[-1] for s in stacks)
        stack = np.stack([s[:, :t_lat] for s in stacks])
        d2 = stack.shape[1]
        mean, logs = stack[:, : d2 // 2], stack[:, d2 // 2:]
        z = self.rng.standard_normal(mean.shape).astype(np.float32) * np.exp(logs) + mean

        max_length = t_lat - 1
        if max_length <= max(it["input_ids"].shape[0] for it in batch) - 1:
            return None
        input_ids = np.full((b, max_length), self.tokenizer.pad_token_id, np.int32)
        mels = []
        keep = np.ones((b,), bool)
        for i, it in enumerate(batch):
            s = min(it["input_ids"].shape[0], max_length)
            input_ids[i, :s] = it["input_ids"][:s]
            if self.rng.random() < self.spk_drop_prob:
                keep[i] = False
            mw = torch.from_numpy(np.asarray(it.get("mel_wav", it["wav"]), np.float32))
            mel = mel_spectrogram(mw, sample_rate=self.mel_sample_rate)
            mels.append(modify_vector(mel, 200)[0].numpy())
        return {
            "input_ids": input_ids,
            "audio_latents": np.transpose(z[:, :, :-1], (0, 2, 1)),
            "distribute_labels": np.transpose(stack[:, :, 1:], (0, 2, 1)),
            "mels": np.stack(mels),
            "speaker_cond_keep": keep,
            "attention_mask": np.ones((b, max_length), np.int32),
            "target_mask": np.ones((b, max_length), bool),
            "end_mask": np.zeros((b, max_length), bool),
        }
