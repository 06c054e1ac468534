"""The training loop (port of kalle_tpu/train/trainer.py: data -> step ->
metrics and checkpoints).

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

Parallel training: the trainer joins torchrun's process group when its
environment is set (`parallel.multihost.initialize`). With a process group
it builds the mesh from TrainConfig's dp/tp/pp (dp -1 takes the ranks the
others leave), shards the params (fsdp: layer weights and AdamW moments
at 1/(tp*dp)), and reads the dataset's dp shard; a dp rank's batch is
padded with loss-neutral rows and positions to the largest shape any dp
rank holds this step, so the ranks' batches form one global batch. A
config asking for dp/tp/pp > 1 or fsdp without a process group raises.
Only the main process writes metrics and checkpoints; a checkpoint holds
the gathered full tensors (every rank takes part in the gather), so a run
saved at one layout restores at another.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..bridge import params_from_jax
from ..core.checkpoint import CheckpointManager, load_reference_llasa_checkpoint
from ..core.config import ExperimentConfig
from ..data.collate import pad_batch_to, stack_microbatches
from ..data.datasets import OfflineLatentDataset, PrefetchLoader
from ..models.lm import llasa
from ..parallel import multihost
from ..parallel.mesh import DP_AXIS, data_shard, make_mesh, param_layout
from ..utils import trace
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
        multihost.initialize(device=self.device.type)
        self.mesh = None
        if dist.is_initialized() or t.dp > 1 or t.tp > 1 or t.pp > 1 or t.fsdp:
            self.mesh = make_mesh(dp=t.dp, tp=t.tp, pp=t.pp, device_type=self.device.type)
            self.device = self.mesh.device
        self.main = multihost.is_main_process()
        os.makedirs(exp.output_dir, exist_ok=True)
        os.makedirs(exp.log_dir, exist_ok=True)
        self.metrics = MetricsWriter(exp.log_dir) if self.main else None
        self.ckpt = CheckpointManager(os.path.join(exp.output_dir, "torch"))
        params, layout = self._init_params(), None
        if self.mesh is not None:
            layout = param_layout(params, self.mesh, fsdp=t.fsdp, pp=t.pp > 1)
            params = layout.shard(params)
        self.state = make_train_state(params, self.tcfg, layout)
        self.state, self.start_step = self.ckpt.restore(self.state)
        if self.start_step and self.main:
            print(f"resumed from step {self.start_step}")
        self.history: list = []  # the metrics of every log line
        self.profiler = None  # set by fit(profile_steps=...)

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
        if self.mesh is not None:  # the dp ranks' batches as one global batch
            lead = torch.tensor(np_batch["input_ids"].shape, device=self.device)
            dist.all_reduce(lead, op=dist.ReduceOp.MAX, group=self.mesh.group(DP_AXIS))
            np_batch = pad_batch_to({k: np_batch[k] for k in BATCH_KEYS}, lead.tolist(),
                                    self.tokenizer.pad_token_id)
        return device_batch(np_batch, self.device)

    def _save(self, step: int, wait: bool = False) -> None:
        """Every rank takes part in gathering the state; the main process
        writes it."""
        sd = self.state.state_dict()
        if self.main:
            self.ckpt.save(step, _Saved(sd), wait=wait)

    def fit(self, max_steps: Optional[int] = None,
            profile_steps: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
        """Train until `max_steps` (or forever). profile_steps=(start, stop):
        steps start..stop (inclusive) run under torch.profiler, kept as
        `self.profiler`.

        Traced (`utils/trace`): each update's spans share its root
        `train.update` (attr `update`, the update's number):
        `train.data_wait` for each batch taken from the loader,
        `train.stack` (stacking the microbatches and the copy to the
        device), `train.step` (`train_step`, attrs `update` and the
        update's `tokens_real` and `tokens_slots`) and, on log steps,
        `train.log` (the metrics' reads and writes). The counters
        `train.tokens_real` (caption ids and frames, from the collated
        masks) and `train.tokens_slots` (the positions the forward computes,
        the device batch's A x B x T) grow by each update's. The update
        marks the tracer (`trace.mark`) once its batch is on the card."""
        exp, tcfg = self.exp, self.tcfg
        shard_index, shard_count = data_shard(self.mesh)
        dataset = OfflineLatentDataset(
            exp.data.meta_path, self.tokenizer, latent_kind=exp.data.latent_kind,
            seed=tcfg.seed, max_length=exp.data.max_length, shard_index=shard_index,
            shard_count=shard_count)
        loader = PrefetchLoader(
            dataset, self.tokenizer.pad_token_id,
            max_token_length=exp.data.max_token_length, batch_size=exp.data.batch_size,
            use_dynamic=exp.data.use_dynamic, buckets=exp.data.length_buckets,
            num_workers=exp.data.num_workers, prefetch=exp.data.prefetch_size)
        step = self.start_step
        last_metrics: Dict[str, float] = {}
        t_last = time.time()
        accum = tcfg.gradient_accumulation_steps
        updates = _updates(loader, accum)
        try:
            while True:
                with trace.span("train.update", update=step + 1):
                    epoch, micro = next(updates)
                    with trace.span("train.stack"):
                        if accum > 1:
                            batch = self._device_batch(stack_microbatches(
                                [{k: b[k] for k in BATCH_KEYS} for b in micro],
                                self.tokenizer.pad_token_id))
                        else:
                            batch = self._device_batch(micro[0])
                    trace.mark(self.device)  # the copy waited for the card
                    np_batch = micro[-1]  # for the log line and the eval hook
                    real = sum(int(b["ids_mask"].sum()) + int(b["audio_mask"].sum())
                               for b in micro)
                    slots = batch["input_ids"].numel()
                    trace.count("train.tokens_real", real)
                    trace.count("train.tokens_slots", slots)
                    if profile_steps and step == profile_steps[0]:
                        self._start_profile()
                    with trace.span("train.step", update=step + 1, tokens_real=real,
                                    tokens_slots=slots):
                        m = train_step(self.state, self.cfg, tcfg, batch, seed=tcfg.seed + 1)
                    if profile_steps and step == profile_steps[1]:
                        self._stop_profile()
                    step += 1

                    if step % tcfg.log_interval == 0:
                        with trace.span("train.log"):
                            m = {k: float(v) for k, v in m.items()}
                            dt = time.time() - t_last
                            t_last = time.time()
                            m["steps_per_s"] = tcfg.log_interval / max(dt, 1e-9)
                            last_metrics = m
                            self.history.append({"step": step, **m})
                            if self.main:
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
                        self._save(step)

                    if max_steps is not None and step >= max_steps:
                        self._save(step, wait=True)
                        multihost.barrier()  # the checkpoint is on disk for every rank
                        return last_metrics
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

    def _stop_profile(self) -> None:
        self._sync()
        self.profiler.__exit__(None, None, None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _updates(loader: PrefetchLoader, accum: int):
    """(epoch, microbatches) of each update: the loader's non-empty batches
    in order, `accum` at a time, an update's batches running across the end
    of an epoch."""
    epoch, buf = 0, []
    while True:
        for np_batch in loader.epoch_iter(epoch):
            if len(np_batch["input_ids"]):
                buf.append(np_batch)
                if len(buf) == accum:
                    yield epoch, buf
                    buf = []
        epoch += 1


class _Saved:
    """A gathered state dict in the shape CheckpointManager.save takes."""

    def __init__(self, sd: dict):
        self.sd = sd

    def state_dict(self) -> dict:
        return self.sd
