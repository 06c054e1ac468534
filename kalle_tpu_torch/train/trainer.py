"""The training loop on one device (port of kalle_tpu/train/trainer.py:
data -> step -> metrics and checkpoints).

dataset -> PrefetchLoader -> an accumulation buffer of A batches ->
`train_step`; a log line every `log_interval` steps in the JAX package's
format (JSONL and the text log too), then the optional eval hook
(`train/eval_hook.py`); a checkpoint every `save_interval` steps and at
`max_steps`, written on the checkpoint manager's thread (the last one
waited for before `fit` returns); resume from the newest checkpoint in
`<output_dir>/torch`.

Initial weights, in order: a random init from the config's seed; the HF
Llama backbone at `llm_model_name_or_path`, through `transformers`
(imported only then; a warning and the random backbone when it fails, as
in the JAX package); a reference Llasa checkpoint at `start_checkpoint`
when that file exists (warm start). A checkpoint of this trainer's own,
when there is one, then takes precedence (resume).

Not ported yet: the dp/tp/pp mesh, fsdp and multi-host (a config asking
for them raises).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_from_jax
from ..core.checkpoint import CheckpointManager, load_reference_llasa_checkpoint
from ..core.config import ExperimentConfig
from ..data.collate import stack_microbatches
from ..data.datasets import OfflineLatentDataset, PrefetchLoader
from ..models.lm import llasa
from .metrics import MetricsWriter
from .step import make_train_state, train_step

BATCH_KEYS = ("input_ids", "audio_latents", "distribute_labels",
              "ids_mask", "audio_mask", "target_mask", "end_mask")


def device_batch(np_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The model's arrays of a collated numpy batch as tensors on `device`
    (input_ids as int64)."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(np_batch[k]))
        out[k] = (t.long() if k == "input_ids" else t).to(device)
    return out


class Trainer:
    def __init__(self, exp: ExperimentConfig, tokenizer,
                 eval_hook: Optional[Callable] = None, device="cuda"):
        self.exp = exp
        self.eval_hook = eval_hook
        self.cfg = exp.model
        self.tcfg = exp.train
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        t = self.tcfg
        if t.tp > 1 or t.pp > 1 or t.dp > 1 or t.fsdp:
            raise NotImplementedError("the port trains on one device: dp/tp/pp meshes "
                                      "and fsdp are not ported yet")
        os.makedirs(exp.output_dir, exist_ok=True)
        os.makedirs(exp.log_dir, exist_ok=True)
        self.metrics = MetricsWriter(exp.log_dir)
        self.ckpt = CheckpointManager(os.path.join(exp.output_dir, "torch"))
        self.state = make_train_state(self._init_params(), self.tcfg)
        self.state, self.start_step = self.ckpt.restore(self.state)
        if self.start_step:
            print(f"resumed from step {self.start_step}")
        self.history: list = []  # the metrics of every log line
        self.profiler = None  # set by fit(profile_steps=...)
        self.profile_wall_s = 0.0

    def _init_params(self) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = llasa.init_params(self.cfg, gen, self.device)
        if self.exp.llm_model_name_or_path:
            path = self.exp.llm_model_name_or_path
            try:
                from transformers import AutoModelForCausalLM

                from ..models.lm.convert import llama_params_from_state_dict

                m = AutoModelForCausalLM.from_pretrained(path, torch_dtype=torch.float32)
                params["llama"] = params_from_jax(
                    llama_params_from_state_dict(m.state_dict(), self.cfg.llama),
                    device=self.device)
                print(f"loaded Llama backbone from {path}")
            except Exception as e:  # noqa: BLE001 — the JAX package warns and goes on
                print(f"WARNING: could not load backbone from {path}: {e}; "
                      "using random init")
        if self.exp.start_checkpoint and os.path.exists(self.exp.start_checkpoint):
            params = load_reference_llasa_checkpoint(self.exp.start_checkpoint, self.cfg,
                                                     self.device)
            print(f"warm-started from {self.exp.start_checkpoint}")
        return params

    def _device_batch(self, np_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return device_batch(np_batch, self.device)

    def fit(self, max_steps: Optional[int] = None,
            profile_steps: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
        """Train until `max_steps` (or forever). profile_steps=(start, stop):
        steps start..stop (inclusive) run under torch.profiler, kept as
        `self.profiler`, with `self.profile_wall_s` their wall time."""
        exp, tcfg = self.exp, self.tcfg
        dataset = OfflineLatentDataset(
            exp.data.meta_path, self.tokenizer, latent_kind=exp.data.latent_kind,
            seed=tcfg.seed, max_length=exp.data.max_length)
        loader = PrefetchLoader(
            dataset, self.tokenizer.pad_token_id,
            max_token_length=exp.data.max_token_length, batch_size=exp.data.batch_size,
            use_dynamic=exp.data.use_dynamic, buckets=exp.data.length_buckets,
            num_workers=exp.data.num_workers, prefetch=exp.data.prefetch_size)
        step, epoch = self.start_step, 0
        last_metrics: Dict[str, float] = {}
        t_last = time.time()
        accum = tcfg.gradient_accumulation_steps
        micro_buf: list = []
        try:
            while True:
                for np_batch in loader.epoch_iter(epoch):
                    if not len(np_batch["input_ids"]):
                        continue
                    if accum > 1:
                        micro_buf.append(np_batch)
                        if len(micro_buf) < accum:
                            continue
                        batch = self._device_batch(stack_microbatches(
                            [{k: b[k] for k in BATCH_KEYS} for b in micro_buf],
                            self.tokenizer.pad_token_id))
                        np_batch = micro_buf[-1]  # for the log line and the eval hook
                        micro_buf = []
                    else:
                        batch = self._device_batch(np_batch)
                    if profile_steps and step == profile_steps[0]:
                        self._start_profile()
                    m = train_step(self.state, self.cfg, tcfg, batch, seed=tcfg.seed + 1)
                    if profile_steps and step == profile_steps[1]:
                        self._stop_profile()
                    step += 1

                    if step % tcfg.log_interval == 0:
                        m = {k: float(v) for k, v in m.items()}
                        dt = time.time() - t_last
                        t_last = time.time()
                        m["steps_per_s"] = tcfg.log_interval / max(dt, 1e-9)
                        last_metrics = m
                        self.history.append({"step": step, **m})
                        self.metrics.log(step, m)
                        line = (f"{time.ctime()}: Epoch:{epoch}, Step:{step}, "
                                f"batch_size:{np_batch['input_ids'].shape[0]}, "
                                f"total_loss:{m['total_loss']:.5f}, "
                                f"audio_loss:{m['audio_loss']:.5f}, "
                                f"end_loss:{m['end_loss']:.5f}")
                        print(line)
                        self.metrics.text_log(line)
                        if self.eval_hook is not None:
                            self.eval_hook(self, step, np_batch)

                    if step % tcfg.save_interval == 0:
                        self.ckpt.save(step, self.state)

                    if max_steps is not None and step >= max_steps:
                        self.ckpt.save(step, self.state, wait=True)
                        return last_metrics
                epoch += 1
        finally:
            loader.close()
            self.ckpt.close()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.profiler = profile(activities=acts)
        self._sync()
        self.profiler.__enter__()
        self._t_profile = time.perf_counter()

    def _stop_profile(self) -> None:
        self._sync()
        self.profile_wall_s = time.perf_counter() - self._t_profile
        self.profiler.__exit__(None, None, None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
