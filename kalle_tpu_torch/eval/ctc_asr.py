"""CTC ASR trained on the tone-coded synthetic language: the WER back-end
(port of kalle_tpu/eval/ctc_asr.py).

The reference scores synthesis through Whisper or Paraformer; with no such
checkpoint in the project, a small acoustic model is trained here on
`data/synth_speech.py` renders and plugged into `eval/harness.wer_pipeline`
as the transcriber.

    log-mel (B, T, n_mels) -> conv stride 2 -> gelu -> residual dilated
    conv blocks -> 1x1 head -> logits over blank + 27 characters

trained with the CTC loss (blank 0; `F.ctc_loss` over the log-softmax, per
sequence, meaned over the batch, as optax's `ctc_loss` meaned) under Adam
and a cosine decay, decoded best-path. gelu is the tanh form (JAX's
default). Convs are NWC with (K, C_in, C_out) kernels, as everywhere in the
port; cuDNN on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import tree_leaves, tree_map
from ..data import synth_speech as sl
from ..ops.conv import conv1d
from ..ops.mel import mel_spectrogram
from ..train.optim import adam_cosine


@dataclasses.dataclass(frozen=True)
class CTCConfig:
    sample_rate: int = 24000
    n_mels: int = 80
    n_fft: int = 1024
    hop: int = 256
    channels: int = 128
    n_blocks: int = 2
    kernel: int = 5
    vocab: int = len(sl.VOCAB)  # labels 1..vocab; 0 = blank

    @staticmethod
    def tiny() -> "CTCConfig":
        return CTCConfig(sample_rate=16000, n_mels=40, n_fft=512, hop=128, channels=64,
                         n_blocks=2)

    @staticmethod
    def for_sample_rate(sr: int, tiny: bool = False) -> "CTCConfig":
        """8 ms hop / 64 ms window at any rate (an ~80 ms character then
        spans ~5 frames after the stride)."""
        hop = max(sr // 125, 8)
        if tiny:
            return CTCConfig(sample_rate=sr, n_mels=32, n_fft=8 * hop, hop=hop, channels=64,
                             n_blocks=2)
        return CTCConfig(sample_rate=sr, n_mels=80, n_fft=8 * hop, hop=hop)


def init_params(cfg: CTCConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random f32 params in the JAX package's tree: conv weights and biases
    uniform(±1/sqrt(C_in*K))."""
    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(cin * k)

        def u(*shape):
            r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return r * (2 * bound) - bound

        return {"w": u(k, cin, cout), "b": u(cout)}

    ch = cfg.channels
    return {"stem": conv(cfg.kernel, cfg.n_mels, ch),
            "blocks": [{"c1": conv(cfg.kernel, ch, ch), "c2": conv(1, ch, ch)}
                       for _ in range(cfg.n_blocks)],
            "head": conv(1, ch, cfg.vocab + 1)}


def forward(params: dict, cfg: CTCConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) log-compressed -> logits (B, ceil(T/2), vocab+1)."""
    pad = cfg.kernel // 2
    x = F.gelu(conv1d(mel, params["stem"]["w"], params["stem"]["b"], stride=2, padding=pad),
               approximate="tanh")
    for i, blk in enumerate(params["blocks"]):
        d = 2 ** i
        r = conv1d(x, blk["c1"]["w"], blk["c1"]["b"], padding=pad * d, dilation=d)
        r = conv1d(F.gelu(r, approximate="tanh"), blk["c2"]["w"], blk["c2"]["b"])
        x = x + r
    return conv1d(x, params["head"]["w"], params["head"]["b"])


def log_mel(cfg: CTCConfig, wav: np.ndarray, device="cuda") -> np.ndarray:
    """wav (T,) -> (frames, n_mels) log mel, the wav peak-normalised first
    (scored wavs come off disk peak-normalised, renders do not)."""
    wav = np.asarray(wav, np.float32)
    wav = wav / (np.abs(wav).max() + 1e-9)
    m = mel_spectrogram(torch.from_numpy(wav)[None].to(device), sample_rate=cfg.sample_rate,
                        n_fft=cfg.n_fft, hop_length=cfg.hop, win_length=cfg.n_fft,
                        n_mels=cfg.n_mels, f_max=cfg.sample_rate / 2.0)
    return torch.log(m[0].clamp_min(1e-5)).T.cpu().numpy()


def greedy_decode(logits: np.ndarray, n_valid: Optional[int] = None) -> str:
    """Best-path CTC decode: per-frame argmax, collapse repeats, drop blanks."""
    ids = np.argmax(np.asarray(logits), axis=-1)
    if n_valid is not None:
        ids = ids[:n_valid]
    out: List[int] = []
    prev = -1
    for i in ids:
        if i != prev and i != 0:
            out.append(int(i))
        prev = int(i)
    return sl.decode_labels(out)


def ctc_loss(params: dict, cfg: CTCConfig, mel, mel_pad, labels, label_pad) -> torch.Tensor:
    """The batch's mean CTC negative log-likelihood. Paddings are 1 where
    padded; a logit frame i is valid where mel frame 2i is."""
    logits = forward(params, cfg, mel)
    lp = mel_pad[:, ::2][:, :logits.shape[1]]
    in_len = (1.0 - lp).sum(1).round().long()
    tgt_len = (1.0 - label_pad).sum(1).round().long()
    nll = F.ctc_loss(F.log_softmax(logits, dim=-1).transpose(0, 1), labels.long(), in_len,
                     tgt_len, blank=0, reduction="none")
    return nll.mean()


def train_step(params: dict, opt, sched, cfg: CTCConfig, mel, mel_pad, labels,
               label_pad) -> torch.Tensor:
    """One Adam update of `params` (leaves requiring grad) in place; the
    loss before it (detached)."""
    loss = ctc_loss(params, cfg, mel, mel_pad, labels, label_pad)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def make_training_bank(cfg: CTCConfig, texts: Sequence[str], n_speakers: int, n_render: int,
                       seed: int = 0, channel: Optional[Callable] = None,
                       channel_prob: float = 1.0,
                       extra_pairs: Sequence[Tuple[str, np.ndarray]] = (), device="cuda"):
    """Render each text by several speakers and seeds into padded buffers.
    `channel` distorts a render (e.g. a codec round trip) with probability
    `channel_prob`; `extra_pairs` appends pre-rendered (text, wav) pairs.
    `device` computes the log mels. Returns numpy (mel (N, T, F), mel_pad,
    labels (N, L), label_pad, texts)."""
    rng = np.random.default_rng(seed)
    mels, labs, outs = [], [], []
    for _ in range(n_render):
        for text in texts:
            spk = int(rng.integers(0, n_speakers))
            wav = sl.render(text, cfg.sample_rate, speaker=spk,
                            seed=int(rng.integers(0, 2**31)))
            if channel is not None and rng.random() < channel_prob:
                wav = np.asarray(channel(wav), np.float32)
            mels.append(log_mel(cfg, wav, device))
            labs.append(sl.encode_text(text))
            outs.append(text)
    for text, wav in extra_pairs:
        mels.append(log_mel(cfg, np.asarray(wav, np.float32), device))
        labs.append(sl.encode_text(text))
        outs.append(text)
    T = max(m.shape[0] for m in mels)
    T = T + (-T) % 2
    L = max(len(lab) for lab in labs)
    mel = np.zeros((len(mels), T, cfg.n_mels), np.float32)
    mel_pad = np.ones((len(mels), T), np.float32)
    labels = np.zeros((len(labs), L), np.int32)
    label_pad = np.ones((len(labs), L), np.float32)
    for i, (m, lab) in enumerate(zip(mels, labs)):
        mel[i, :m.shape[0]] = m
        mel_pad[i, :m.shape[0]] = 0.0
        labels[i, :len(lab)] = lab
        label_pad[i, :len(lab)] = 0.0
    return mel, mel_pad, labels, label_pad, outs


def train_ctc(cfg: CTCConfig, texts: Sequence[str], n_speakers: int = 4, n_render: int = 4,
              steps: int = 600, batch: int = 16, lr: float = 3e-4, seed: int = 0,
              log_every: int = 0, channel: Optional[Callable] = None,
              channel_prob: float = 1.0,
              extra_pairs: Sequence[Tuple[str, np.ndarray]] = (),
              device="cuda") -> Tuple[dict, List[float]]:
    """Train the CTC ASR on rendered texts on `device`. Returns (params, the
    loss every `log_every` steps and the last)."""
    bank = make_training_bank(cfg, texts, n_speakers, n_render, seed, channel=channel,
                              channel_prob=channel_prob, extra_pairs=extra_pairs, device=device)
    mel, mel_pad, labels, label_pad = (torch.from_numpy(a).to(device) for a in bank[:4])
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = adam_cosine(leaves, lr, steps, 0.05)
    rng = np.random.default_rng(seed + 1)
    curve = []
    loss = None
    for i in range(steps):
        idx = torch.from_numpy(rng.choice(mel.shape[0], batch,
                                          replace=batch > mel.shape[0])).to(device)
        loss = train_step(params, opt, sched, cfg, mel[idx], mel_pad[idx], labels[idx],
                          label_pad[idx])
        if log_every and i % log_every == 0:
            curve.append(float(loss))
    curve.append(float(loss))
    return tree_map(lambda t: t.detach(), params), curve


@torch.no_grad()
def transcribe_array(params: dict, cfg: CTCConfig, wav: np.ndarray, sr: int) -> str:
    """A waveform ((T,) or (C, T), any rate) -> text, on the params' device."""
    from ..utils.audio import resample_linear

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    if sr != cfg.sample_rate:
        wav = resample_linear(wav[None], sr, cfg.sample_rate)[0]
    dev = params["head"]["w"].device
    m = log_mel(cfg, wav, dev)
    T = m.shape[0] + (-m.shape[0]) % 2
    mel = np.zeros((1, T, cfg.n_mels), np.float32)
    mel[0, :m.shape[0]] = m
    logits = forward(params, cfg, torch.from_numpy(mel).to(dev))
    return greedy_decode(logits[0].cpu().numpy(), n_valid=(m.shape[0] + 1) // 2)


def make_ctc_transcriber(params: dict, cfg: CTCConfig) -> Callable[[str], str]:
    """wav path -> text, for eval/harness.run_asr and wer_pipeline."""
    from ..utils.audio import read_wav

    def transcribe(wav_path: str) -> str:
        audio, sr = read_wav(wav_path)
        return transcribe_array(params, cfg, audio, sr)

    return transcribe
