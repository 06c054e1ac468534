"""Trained speaker embedder: the speaker-similarity back-end (port of
kalle_tpu/eval/speaker_embedder.py).

The reference scores voice cloning with a trained WavLM-ECAPA; with no such
checkpoint in the project, the port's ECAPA-TDNN
(models/conditioning/ecapa.py) plus a linear head is trained here on
speaker classification over `data/synth_speech.py`'s speaker profiles
(random sentences, so only the acoustics identify the speaker). The head
is thrown away; the embedding separates same-speaker from cross-speaker
pairs (`margin`), which a random ECAPA cannot. Adam under a cosine decay,
the softmax cross-entropy meaned over the batch; every ECAPA leaf trains,
its BatchNorm statistics included, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import tree_leaves, tree_map
from ..data import synth_speech as sl
from ..models.conditioning import ecapa as ecapa_mod
from ..ops.mel import mel_spectrogram
from ..train.optim import adam_cosine


@dataclasses.dataclass(frozen=True)
class SpeakerTrainConfig:
    sample_rate: int = 16000
    n_mels: int = 80
    n_speakers: int = 8
    utt_per_speaker: int = 12
    utt_seconds: float = 0.9
    steps: int = 500
    batch: int = 16
    lr: float = 2e-3
    seed: int = 0

    @staticmethod
    def tiny() -> "SpeakerTrainConfig":
        return SpeakerTrainConfig(sample_rate=8000, n_mels=40, n_speakers=6, utt_per_speaker=8,
                                  steps=350)


def _mel(cfg: SpeakerTrainConfig, wav: np.ndarray, device="cuda") -> np.ndarray:
    """wav (T,) -> (frames, n_mels) log mel."""
    m = mel_spectrogram(torch.from_numpy(np.asarray(wav, np.float32))[None].to(device),
                        sample_rate=cfg.sample_rate, n_mels=cfg.n_mels,
                        f_max=cfg.sample_rate / 2.0)
    return torch.log(m[0].clamp_min(1e-5)).T.cpu().numpy()


def _render_bank(cfg: SpeakerTrainConfig, seed_off: int = 0,
                 channel: Optional[Callable] = None, device="cuda"):
    """(mels (N, T, F), labels (N,)) numpy: random sentences per speaker,
    each render cut to utt_seconds."""
    rng = np.random.default_rng(cfg.seed + seed_off)
    T = int(cfg.utt_seconds * cfg.sample_rate)
    mels, labels = [], []
    for spk in range(cfg.n_speakers):
        for _ in range(cfg.utt_per_speaker):
            text = sl.random_sentence(rng)
            while len(sl.render(text, cfg.sample_rate, speaker=spk, seed=seed_off)) < T:
                text += " " + sl.random_sentence(rng)
            wav = sl.render(text, cfg.sample_rate, speaker=spk,
                            seed=int(rng.integers(0, 2**31)))[:T]
            if channel is not None:
                wav = np.asarray(channel(wav), np.float32)[:T]
            mels.append(_mel(cfg, wav, device))
            labels.append(spk)
    t = min(m.shape[0] for m in mels)
    mel = np.stack([m[:t] for m in mels]).astype(np.float32)
    return mel, np.asarray(labels, np.int32)


def _ecapa_cfg(cfg: SpeakerTrainConfig) -> ecapa_mod.EcapaConfig:
    return ecapa_mod.EcapaConfig(in_channels=cfg.n_mels, channels=32, embd_dim=32, scale=4,
                                 attn_bottleneck=16, pooled_channels=96)


def init_head(ecfg: ecapa_mod.EcapaConfig, n_speakers: int, generator: torch.Generator,
              device="cuda") -> dict:
    """The classification head: w 0.05 * N(0, 1) (embd_dim, n_speakers), b 0."""
    w = 0.05 * torch.randn(ecfg.embd_dim, n_speakers, generator=generator, device=device)
    return {"w": w, "b": torch.zeros(n_speakers, device=device)}


def train_step(params: dict, head: dict, opt, sched, ecfg: ecapa_mod.EcapaConfig,
               mel: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One Adam update of ECAPA and the head (leaves requiring grad) in
    place; the loss before it (detached)."""
    logits = ecapa_mod.forward(params, ecfg, mel) @ head["w"] + head["b"]
    loss = F.cross_entropy(logits, labels.long())
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def train_speaker_embedder(cfg: SpeakerTrainConfig = SpeakerTrainConfig(),
                           channel: Optional[Callable] = None, device="cuda"
                           ) -> Tuple[dict, ecapa_mod.EcapaConfig, List[float]]:
    """Train ECAPA + a linear head on speaker ID on `device`. Returns (ecapa
    params, ecapa cfg, the loss every 50 steps and the last)."""
    ecfg = _ecapa_cfg(cfg)
    mel_np, labels_np = _render_bank(cfg, channel=channel, device=device)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    params = ecapa_mod.init_params(ecfg, g, device)
    head = init_head(ecfg, cfg.n_speakers, g, device)
    leaves = tree_leaves(params) + tree_leaves(head)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = adam_cosine(leaves, cfg.lr, cfg.steps, 0.05)
    rng = np.random.default_rng(cfg.seed + 7)
    mel, labels = torch.from_numpy(mel_np).to(device), torch.from_numpy(labels_np).to(device)
    curve = []
    loss = None
    for i in range(cfg.steps):
        idx = torch.from_numpy(rng.choice(mel.shape[0], cfg.batch,
                                          replace=cfg.batch > mel.shape[0])).to(device)
        loss = train_step(params, head, opt, sched, ecfg, mel[idx], labels[idx])
        if i % 50 == 0:
            curve.append(float(loss))
    curve.append(float(loss))
    return tree_map(lambda t: t.detach(), params), ecfg, curve


@torch.no_grad()
def embed_waveform(params, ecfg, cfg: SpeakerTrainConfig, wav: np.ndarray,
                   sr: int) -> np.ndarray:
    """A waveform ((T,) or (C, T), any rate) -> its embedding (embd_dim,),
    on the params' device."""
    from ..utils.audio import resample_linear

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    if sr != cfg.sample_rate:
        wav = resample_linear(wav[None], sr, cfg.sample_rate)[0]
    dev = params["linear"]["w"].device
    m = _mel(cfg, wav, dev)
    return ecapa_mod.forward(params, ecfg, torch.from_numpy(m[None]).to(dev))[0].cpu().numpy()


def make_trained_embedder(params, ecfg, cfg: SpeakerTrainConfig
                          ) -> Callable[[str], np.ndarray]:
    """wav path -> embedding, for eval/harness.speaker_similarity."""
    from ..utils.audio import read_wav

    def embed(wav_path: str) -> np.ndarray:
        audio, sr = read_wav(wav_path)
        return embed_waveform(params, ecfg, cfg, audio, sr)

    return embed


@torch.no_grad()
def margin(params, ecfg, cfg: SpeakerTrainConfig, n_pairs: int = 24, seed_off: int = 9000,
           channel: Optional[Callable] = None) -> Tuple[float, float]:
    """Held-out discrimination: the mean cosine of same-speaker pairs and of
    cross-speaker pairs over fresh renders (2 a speaker). -> (pos, neg)."""
    eval_cfg = dataclasses.replace(cfg, utt_per_speaker=2)
    dev = params["linear"]["w"].device
    mel, labels = _render_bank(eval_cfg, seed_off=seed_off, channel=channel, device=dev)
    embs = ecapa_mod.forward(params, ecfg, torch.from_numpy(mel).to(dev)).cpu().numpy()
    embs = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9)
    sims = embs @ embs.T
    n = len(labels)
    pos = [sims[i, j] for i in range(n) for j in range(i + 1, n) if labels[i] == labels[j]]
    neg = [sims[i, j] for i in range(n) for j in range(i + 1, n) if labels[i] != labels[j]]
    return float(np.mean(pos)), float(np.mean(neg))
