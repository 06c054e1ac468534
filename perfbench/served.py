"""The check of a served model: what the program served for a sample of
requests against the plain reference over the same prompts and fed-back
frames, for the drivers that serve (stream, synth).

A `Served` request holds the prompt the harness built, the frames the
program sampled and fed back, the means it put out, and each piece of
audio the client got with the latent window it should have been decoded
from. `check` redraws the weights from the seed, runs the reference (or,
with the traffic's `controls`, also the control: int4 layer weights and
an fp8 codec in the program's place) and gives each number compared with
its limit:

  frame_gap  the worst served frame's distance from the reference's mean,
             over the request's RMS reference mean;
  pcm_gap    the worst piece of audio's RMS distance from the reference
             codec's decode of its window, over the request's RMS
             reference audio.
"""
from __future__ import annotations

import gc
import math
import threading
import time
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import modelcfg, tracing, weights

SPECIAL_END, SPECIAL_START = 7, 4  # speech_understanding_end, speech_generation_start


def prompt_ids(text: str, base_vocab: int) -> np.ndarray:
    """The prompt the program builds for `text`: its UTF-8 bytes, then the
    two audio specials (the texts here need no whitespace folding)."""
    return np.asarray(list(text.encode()) + [base_vocab + SPECIAL_END,
                                             base_vocab + SPECIAL_START], np.int64)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_model(run, clock, s: dict):
    """The program's served model from the seed: kernels built, weights
    drawn on the device, layer weights quantized to int8, and the codec;
    returns (LlasaConfig, params, codec), each part of set-up timed on
    `clock`."""
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    cfg = run.cfg
    dev = torch.device(run.device)
    if dev.type == "cuda":
        from kalle_tpu_torch.ops.kernels import _build

        _build.build()
    clock.lap("build")
    lcfg = modelcfg.llasa_config(cfg, "serve")
    params = weights.lm_params(s, run.seed, dev, dtype=getattr(torch, cfg["serve"]["dtype"]))
    codec_dt = getattr(torch, cfg["serve"]["codec_dtype"])
    ccfg = codec_cfg(run)
    codec = Codec("sigma", SigmaVAEConfig(**ccfg),
                  weights.codec_params(run.seed, dev, codec_dt, ccfg)).astype(codec_dt)
    sync(dev)
    clock.lap("weights")
    if cfg["serve"]["layer_weights"] != "int8":
        raise ValueError("the serving drivers serve int8 layer weights")
    params = quantize_llama_params(params, bits=8)
    gc.collect()
    sync(dev)
    clock.lap("quantize")
    modelcfg.check_widths(cfg, lcfg, params)
    return lcfg, params, codec


class TimedCodec:
    """The program's codec as the serving path sees it, timing each
    decode (a call ends in a host copy, so its time holds the device
    work)."""

    def __init__(self, codec):
        self.codec = codec
        self.samples_per_frame = codec.samples_per_frame
        self.calls: List[tuple] = []  # (start, seconds, frames)
        self._lock = threading.Lock()

    def decode_latents(self, latents, *a, **k):
        with tracing.span("codec"):
            t0 = time.perf_counter()
            out = self.codec.decode_latents(latents, *a, **k)
            dt = time.perf_counter() - t0
        with self._lock:
            self.calls.append((t0, dt, int(np.shape(latents)[1])))
        return out


@dataclass
class Served:
    ids: torch.Tensor        # (n,) the prompt
    frames: torch.Tensor     # (F, d) the frames sampled and fed back
    means: torch.Tensor      # (S, d) the means served, S <= F
    # (lo, a, b, keep, audio): audio should be the decode of frames[lo:b]
    # from frame a on, cut to `keep` frames
    windows: List[Tuple[int, int, int, int, torch.Tensor]]


def codec_cfg(run) -> dict:
    c = dict(weights.SIGMAVAE)
    c.update(run.traffic.get("codec", {}))
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()}


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def outputs(run, s: dict, served: List[Served], layer_bits: int, precision: str):
    """Means and audio of the reference (or the control) over the served
    prompts and frames."""
    from .reference.llasa import Model, prepare
    from .reference.sigmavae import Decoder

    dev = torch.device(run.device)
    dt = getattr(torch, run.cfg["serve"]["dtype"])
    codec_dt = getattr(torch, run.cfg["serve"]["codec_dtype"])
    ccfg = codec_cfg(run)
    hop = math.prod(ccfg["strides"])
    w = weights.lm_params(s, run.seed, dev, dtype=dt)
    model = Model(s, prepare(w, layer_bits=layer_bits))
    del w
    dec = Decoder(weights.codec_params(run.seed, dev, codec_dt, ccfg), ccfg,
                  precision=precision)
    out = []
    for r in served:
        audio = [dec(r.frames[lo:b][None])[0, (a - lo) * hop:(a - lo + keep) * hop]
                 .clamp(-1, 1) for lo, a, b, keep, _got in r.windows]
        out.append((model.served_means(r.ids, r.frames[:len(r.means)]), audio))
    del model, dec
    free(dev)
    return out


def gaps(got, ref) -> dict:
    frame = pcm = 0.0
    for (g_means, g_audio), (r_means, r_audio) in zip(got, ref):
        scale = r_means.norm(dim=-1).pow(2).mean().sqrt()
        frame = max(frame, float(((g_means - r_means).norm(dim=-1) / scale).max()))
        rms = torch.cat(r_audio).pow(2).mean().sqrt().clamp_min(1e-6)
        for g, y in zip(g_audio, r_audio):
            # a piece of the wrong length is as far off as a piece can be
            # (kept finite, so the result line stays plain JSON)
            pcm = max(pcm, 1e9 if g.shape != y.shape
                      else float((g - y).pow(2).mean().sqrt() / rms))
    return {"frame_gap": frame, "pcm_gap": pcm}


def check(run, s: dict, served: List[Served], n_wanted: int):
    """(checks, notes): each number compared with its limit; None where
    fewer requests than sampled came back."""
    from .reference.llasa import strict_f32

    program = [(r.means, [got for *_w, got in r.windows]) for r in served]
    notes = []
    with strict_f32():
        ref = outputs(run, s, served, 8, "f32")
        got = gaps(program, ref)
        if run.traffic.get("controls"):  # the configuration's precision one step down
            notes.append("control readings " + " ".join(
                f"{k} {v:.6g}" for k, v in gaps(outputs(run, s, served, 4, "fp8"),
                                                 ref).items()))
    notes.insert(0, f"checked {len(served)} of {n_wanted} sampled requests, "
                    f"{sum(len(r.means) for r in served)} served frames")
    enough = len(served) == n_wanted and n_wanted > 0
    checks = {k: {"value": (v if enough else None), "limit": run.limits[k]}
              for k, v in got.items()}
    return checks, notes
