"""Web demo helpers (port of kalle_tpu/serve/web.py).

A Gradio app around the single-utterance API (`InferTools.synthesize`):
text normalization, an optional reference voice, an HTML error message,
an upload validity check through ffmpeg, and the streaming wav chunk
header the HTTP server sends. gradio is optional; `build_app` raises a
clear ImportError without it, and every other helper stands alone.
"""
from __future__ import annotations

import html
import os
import struct
import subprocess
import tempfile
import wave
from typing import Callable

import numpy as np

from ..utils.audio import resample_linear


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


def build_html_error_message(error) -> str:
    """A red bold error div, html-escaped."""
    return f"""
    <div style="color: red;
    font-weight: bold;">
        {html.escape(str(error))}
    </div>
    """


def check_audio_validity(wav_data: bytes) -> bool:
    """Whether uploaded audio bytes decode: `ffmpeg -v error -i f -f null -`
    on a temp file, or, where ffmpeg is absent, a stdlib `wave` parse of
    the header (wav only)."""
    with tempfile.NamedTemporaryFile(delete=False, suffix=".wav") as tmp:
        tmp.write(wav_data)
        name = tmp.name
    try:
        try:
            subprocess.run(["ffmpeg", "-v", "error", "-i", name, "-f", "null", "-"],
                           check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            return True
        except FileNotFoundError:
            try:
                with wave.open(name, "rb") as w:
                    return w.getnframes() >= 0 and w.getframerate() > 0
            except (wave.Error, EOFError):
                return False
        except subprocess.CalledProcessError:
            return False
    finally:
        os.remove(name)


def make_safe_synthesize_fn(infer_tools, max_frames: int = 200) -> Callable:
    """The demo-facing wrapper: ((sr, int16 wav), "no error") on success,
    (None, "error:<msg>") on failure; it never raises into the UI."""
    synthesize = make_synthesize_fn(infer_tools, max_frames)

    def safe(reference_audio, reference_text, text, enable_reference_audio=False):
        try:
            if not normalize_text(text):
                raise ValueError("empty text")
            return (synthesize(reference_audio, reference_text, text,
                               enable_reference_audio), "no error")
        except Exception as e:  # noqa: BLE001 — the UI boundary reports it
            return None, f"error:{e}"

    return safe


def make_synthesize_fn(infer_tools, max_frames: int = 200) -> Callable:
    """(reference_audio, reference_text, text, enable_reference) -> (sr,
    int16 wav). A reference `(sr, samples)` (int16 range detected by its
    peak) is resampled to the codec's rate and encoded; the sigma codec's
    means (T, d) become the prompt latents."""

    def synthesize(reference_audio, reference_text, text, enable_reference_audio=False):
        text = normalize_text(text)
        prompt_latents = None
        if enable_reference_audio and reference_audio is not None:
            sr, wav = reference_audio
            wav = np.asarray(wav, np.float32)
            if wav.ndim == 1:
                wav = wav[None]
            if np.abs(wav).max() > 1.5:  # int16 input
                wav = wav / 32768.0
            wav = resample_linear(wav, sr, infer_tools.codec.sample_rate)
            z = np.asarray(infer_tools.codec.encode_audio(wav[None]))[0]
            if infer_tools.codec.kind == "sigma":
                prompt_latents = z  # sigma encode is already (T, d)
            else:
                # the other codecs encode channel-first (2d, T) mean||scale:
                # condition on the means, time-first
                prompt_latents = z[:infer_tools.cfg.latent_dim].T
        audio = infer_tools.synthesize(text, max_frames=max_frames,
                                       prompt_latents=prompt_latents)
        mono = np.asarray(audio)[0]
        return infer_tools.codec.sample_rate, (np.clip(mono, -1, 1) * 32767).astype(np.int16)

    return synthesize


def build_app(infer_tools, max_frames: int = 200):
    """The Gradio Blocks app (needs `gradio`)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed; `pip install gradio` to serve "
                          "the web demo, or run serve.app with --http") from e

    synthesize = make_safe_synthesize_fn(infer_tools, max_frames)
    with gr.Blocks(title="kalle_tpu TTS") as app:
        gr.Markdown("# kalle_tpu — continuous-latent speech LM")
        with gr.Row():
            with gr.Column():
                ref_audio = gr.Audio(label="Reference audio (optional)")
                ref_text = gr.Textbox(label="Reference text")
                enable_ref = gr.Checkbox(label="Use reference audio")
                text = gr.Textbox(label="Text to synthesize")
                btn = gr.Button("Synthesize")
            with gr.Column():
                out = gr.Audio(label="Generated audio")
                err = gr.Text(label="Error message", visible=True)
        btn.click(synthesize, [ref_audio, ref_text, text, enable_ref], [out, err])
    return app
