"""Mid-training listening test (port of kalle_tpu/train/eval_hook.py).

`make_eval_audio_hook(codec)` returns the `eval_hook(trainer, step,
np_batch)` that `Trainer.fit` calls on each log step. Every `every`-th
call it runs the training forward (no gradients) on the logged batch and,
for its first row, writes into `out_dir` (default
`<exp_dir>/<project_name>/eval_audios`):
  * `sample_{step}-gen.wav`: the predicted means of the row's audio frames
    (plus sigma * N(0, 1) from `np.random.default_rng(step)` for the sigma
    head, as the JAX package draws them) through the codec;
  * `sample_{step}-gt.wav`: the row's ground-truth latents through the codec;
  * `sample_{step}-gen.txt`: the row's caption;
  * `sample_{step}-gt2.wav`: a copy of the row's source wav, when it exists.
The forward's own noise (the sigma head's input latents) comes from a
`torch.Generator` seeded with the step. The codec decodes on its own
device: a bf16 SigmaVAE on the card runs K4.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..models.lm import llasa
from ..utils.audio import write_wav
from .trainer import device_batch


def make_eval_audio_hook(codec, out_dir: Optional[str] = None, every: int = 1):
    """-> eval_hook(trainer, step, np_batch) for Trainer."""
    calls = {"n": 0}

    def hook(trainer, step, np_batch):
        calls["n"] += 1
        if calls["n"] % every:
            return
        cfg = trainer.cfg
        with torch.no_grad():  # every rank of a parallel run takes part
            out = llasa.forward(trainer.state.params, cfg,
                                device_batch(np_batch, trainer.device),
                                generator=torch.Generator(device=trainer.device)
                                .manual_seed(step), layout=trainer.state.layout)
        if not trainer.main:  # the main process writes its first row's files
            return
        d = out_dir or os.path.join(trainer.exp.exp_dir, trainer.exp.project_name,
                                    "eval_audios")
        os.makedirs(d, exist_ok=True)
        audio_mask = np.asarray(np_batch["audio_mask"][0], bool)
        if not audio_mask.any():
            return
        sr = codec.sample_rate

        # predicted: sample from pre_mean as the reference does
        mean = out["pre_mean"][0].float().cpu().numpy()
        if cfg.head_variant == "sigma":
            lat = mean + cfg.sigma * np.random.default_rng(step).standard_normal(
                mean.shape).astype(np.float32)
        else:
            lat = mean
        audio = codec.decode_latents(lat[audio_mask][None])
        write_wav(os.path.join(d, f"sample_{step}-gen.wav"), audio[0], sr)

        gt = np.asarray(np_batch["audio_latents"][0], np.float32)[audio_mask][None]
        audio = codec.decode_latents(gt)
        write_wav(os.path.join(d, f"sample_{step}-gt.wav"), audio[0], sr)

        text = (np_batch.get("raw_texts") or [""])[0]
        with open(os.path.join(d, f"sample_{step}-gen.txt"), "w") as f:
            f.write(text)
        src = (np_batch.get("speech_paths") or [""])[0]
        if src and os.path.exists(src):
            shutil.copy2(src, os.path.join(d, f"sample_{step}-gt2.wav"))

    return hook
