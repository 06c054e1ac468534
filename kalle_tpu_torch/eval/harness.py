"""ASR and speaker-similarity evaluation harnesses (port of
kalle_tpu/eval/harness.py), the counterparts of the reference's
tools/asr_test.py, tools/compute-wer.sh and tools/sim_test.py:

  * meta.lst rows `utt|prompt_text|prompt_wav|target_text`;
  * `run_asr` transcribes each `{utt}{gen_suffix}` and writes aaa_gt.txt /
    aaa_asr.txt with punctuation turned into spaces; `wer_pipeline` scores
    them into `000000000_wer{tag}.txt` (eval/wer.py);
  * `speaker_similarity` writes the per-utterance cosines to
    `0000000_sim,json` (the reference's file name, comma included) and
    their mean to `0000000_sim.txt`.

Transcribers and embedders are injected (wav path -> text / embedding):
the CTC ASR (eval/ctc_asr.py), the trained ECAPA (eval/speaker_embedder.py
or `make_ecapa_embedder`), or the weight-free `make_spectral_embedder`.
The reference's Whisper and Paraformer back-ends need downloaded weights
and are not in the port: `make_transcriber` raises.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .wer import compute_wer, read_trn

_PUNCT = re.compile(r"[^\w\s一-鿿]")


@dataclass
class MetaItem:
    utt: str
    prompt_text: str
    prompt_wav: str
    target_text: str


def read_meta_lst(path: str) -> List[MetaItem]:
    items = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            items.append(MetaItem(*line.split("|")[:4]))
    return items


def clean_text(text: str) -> str:
    """punctuation -> space."""
    return " ".join(_PUNCT.sub(" ", text).split())


def make_transcriber(lang: str, **kwargs) -> Callable[[str], str]:
    """The reference's language dispatch (en: Whisper-large-v3, zh:
    Paraformer). Both need downloaded weights, which the port does not
    load: pass a transcriber (e.g. `ctc_asr.make_ctc_transcriber`)."""
    if lang in ("en", "zh"):
        raise ValueError(f"no built-in {lang!r} transcriber: the reference's Whisper and "
                         "Paraformer back-ends need downloaded weights and are not in the "
                         "port; pass transcriber= (e.g. eval.ctc_asr.make_ctc_transcriber)")
    raise ValueError(f"unsupported ASR language {lang!r} (en|zh)")


def run_asr(lang: str, wav_dir: str, meta: List[MetaItem],
            transcriber: Optional[Callable[[str], str]] = None,
            gen_suffix: str = "---gen.wav") -> Tuple[str, str]:
    """Transcribe every {utt}{gen_suffix} (else {utt}.wav) in wav_dir that
    meta lists -> (aaa_gt.txt, aaa_asr.txt) paths."""
    if transcriber is None:
        transcriber = make_transcriber(lang)
    gt_path = os.path.join(wav_dir, "aaa_gt.txt")
    asr_path = os.path.join(wav_dir, "aaa_asr.txt")
    with open(gt_path, "w", encoding="utf-8") as gt, \
            open(asr_path, "w", encoding="utf-8") as hyp:
        for item in meta:
            wav = os.path.join(wav_dir, item.utt + gen_suffix)
            if not os.path.exists(wav):
                wav = os.path.join(wav_dir, item.utt + ".wav")
            if not os.path.exists(wav):
                continue
            text = transcriber(wav)
            gt.write(f"{item.utt} {clean_text(item.target_text)}\n")
            hyp.write(f"{item.utt} {clean_text(text)}\n")
    return gt_path, asr_path


def wer_pipeline(lang: str, wav_dir: str, meta_path: str,
                 transcriber: Optional[Callable[[str], str]] = None,
                 char_level: Optional[bool] = None, gen_suffix: str = "---gen.wav") -> float:
    """asr -> scorer -> 000000000_wer{tag}.txt (no tag for ---gen.wav,
    `_copysyn` for ---copysyn.wav); returns the WER in percent."""
    meta = read_meta_lst(meta_path)
    gt, hyp = run_asr(lang, wav_dir, meta, transcriber, gen_suffix=gen_suffix)
    char_level = (lang == "zh") if char_level is None else char_level
    tag = "" if gen_suffix == "---gen.wav" else "_" + gen_suffix.split(".")[0].strip("-")
    out_path = os.path.join(wav_dir, f"000000000_wer{tag}.txt")
    with open(out_path, "w", encoding="utf-8") as f:
        wer, _ = compute_wer(read_trn(gt), read_trn(hyp), char_level=char_level,
                             verbose=True, out=f)
    return wer


def speaker_similarity(wav_dir: str, meta: List[MetaItem],
                       embed_fn: Callable[[str], np.ndarray],
                       gen_suffix: str = "---gen.wav") -> float:
    """Cosine similarity of the prompt's and the generated wav's embeddings
    for each listed utterance with both files; writes `0000000_sim,json`
    and the mean to `0000000_sim.txt`, returns the mean (0.0 for none)."""
    sims: Dict[str, float] = {}
    for item in meta:
        gen = os.path.join(wav_dir, item.utt + gen_suffix)
        if not (os.path.exists(gen) and os.path.exists(item.prompt_wav)):
            continue
        a = embed_fn(item.prompt_wav)
        b = embed_fn(gen)
        sims[item.utt] = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    with open(os.path.join(wav_dir, "0000000_sim,json"), "w") as f:
        json.dump(sims, f, indent=2)
    mean = float(np.mean(list(sims.values()))) if sims else 0.0
    with open(os.path.join(wav_dir, "0000000_sim.txt"), "w") as f:
        f.write(f"{mean}\n")
    return mean


def _mono_mel(wav_path: str, sample_rate: int, device) -> torch.Tensor:
    """A wav file -> its mono mel (1, n_mels, T) at `sample_rate` on `device`."""
    from ..ops.mel import mel_spectrogram
    from ..utils.audio import read_wav, resample_linear

    audio, sr = read_wav(wav_path)
    mono = resample_linear(audio, sr, sample_rate).mean(axis=0, keepdims=True)
    return mel_spectrogram(torch.from_numpy(np.ascontiguousarray(mono, np.float32)).to(device),
                           sample_rate=sample_rate)


def make_spectral_embedder(sample_rate: int = 16000, device="cuda"
                           ) -> Callable[[str], np.ndarray]:
    """Weight-free speaker fingerprint: each mel band's log mean and std
    over time (long-term spectrum statistics), which separate the synthetic
    speakers' formant and f0 structure where a random ECAPA cannot."""
    def embed(wav_path: str) -> np.ndarray:
        logm = torch.log(_mono_mel(wav_path, sample_rate, device)[0].clamp_min(1e-5))
        logm = logm.double().cpu().numpy()  # (n_mels, T)
        return np.concatenate([logm.mean(axis=1), logm.std(axis=1)]).astype(np.float32)

    return embed


def make_ecapa_embedder(params, ecapa_cfg, sample_rate: int = 16000
                        ) -> Callable[[str], np.ndarray]:
    """Speaker embedder from the port's ECAPA over the default mel frontend,
    on the params' device."""
    from ..models.conditioning import ecapa as ecapa_mod

    dev = params["linear"]["w"].device

    @torch.no_grad()
    def embed(wav_path: str) -> np.ndarray:
        mel = _mono_mel(wav_path, sample_rate, dev)
        return ecapa_mod.forward(params, ecapa_cfg, mel.transpose(1, 2))[0].cpu().numpy()

    return embed
