"""Training through the program's `train/trainer.Trainer.fit`: dynamic
token-budget microbatches over the length buckets, gradient accumulation,
AdamW with warm-up and cosine decay, the loader on one thread.

The rows (captions and sigma latents, written as the trainer's dataset
under the run's temporary directory) are drawn from the seed: every seed
gets the same sets of caption and latent lengths, in its own order, and its
own values. The weights are the benchmark's, drawn from the seed and copied
into the trainer's f32 masters before the first step.

The trainer runs as the reference job configures it, a log line every
`log_interval` updates. The harness sees each update through thin
wrappers around the trainer's `stack_microbatches` (the tokens of the
update's batch, counted on the host from the collated masks) and
`train_step` (the update's number, after it was issued); in the window
they read nothing from the card. Set-up drives the trainer through its
first `check_steps` updates (their losses, the first gradient as AdamW's
first moment holds it, and each leaf's change are kept for the check) and
`ramp_steps` more; the window then runs whole updates until `--seconds`
have passed, and closes when the card has finished them.
`train_tokens_per_s` is the unpadded tokens (caption ids and frames) of the
window's updates over its length. Which rows make each update follows from
the order the dataset shuffles them in and the token-budget rule (`plan`),
and every update's batch is held to it.

`correct`: the plain reference repeats the first `check_steps` updates from
the same weights, rows and input noise: each step's loss (`loss_gap`), the
first gradient's norm by leaf (`grad_gap`) and each leaf's change after
the steps (`change_gap`).
"""
from __future__ import annotations

import bisect
import gc
import json
import math
import os
import random
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import modelcfg, tracing, weights
from ..common import lognormal_int_ppf, quantile_set, sub_seed, text_of
from ..flops import bound as bound_mod
from ..flops import flash as flash_flops
from ..flops import llasa as llasa_flops
from . import Clock, Outcome, Run

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class _WindowClosed(Exception):
    pass


# ---------------------------------------------------------------------------
# the rows and the steps they make
# ---------------------------------------------------------------------------

def make_rows(tr: dict, seed: int) -> List[dict]:
    """Captions (their lengths in characters) and latents of each row."""
    n = tr["rows"]
    rng = random.Random(sub_seed(seed, 31))
    chars = quantile_set(n, lognormal_int_ppf(*tr["text_chars"]))
    frames = quantile_set(n, lognormal_int_ppf(*tr["frames"]))
    rng.shuffle(chars)
    rng.shuffle(frames)
    rows = []
    for c, f in zip(chars, frames):
        text = text_of(rng, c)
        rows.append({"text": text, "ids": len(text.encode()) + 2, "frames": f})
    return rows


def latents(rows: List[dict], seed: int, dim: int) -> List[np.ndarray]:
    rng = np.random.default_rng(sub_seed(seed, 33))
    return [rng.standard_normal((r["frames"], dim), dtype=np.float32) for r in rows]


def plan(rows: List[dict], tr: dict, n_steps: int) -> List[List[List[int]]]:
    """The rows of the first `n_steps` updates, as microbatches: each epoch
    visits the rows in `random.Random(epoch)`'s shuffle and packs them by
    the token budget (a microbatch closes when its longest row times its
    rows would pass `max_token_length`, or at `batch_size` rows; the
    epoch's tail is a microbatch); `grad_accum` microbatches make a step."""
    steps: List[List[List[int]]] = []
    buf: List[List[int]] = []
    epoch = 0
    budget, cap = tr["max_token_length"], tr["batch_size"]
    while len(steps) < n_steps:
        order = list(range(len(rows)))
        random.Random(epoch).shuffle(order)
        cur: List[int] = []
        cur_max = 0
        micro = []
        for i in order:
            n = rows[i]["ids"] + rows[i]["frames"]
            m = max(n, cur_max)
            if m * (len(cur) + 1) <= budget and len(cur) < cap:
                cur.append(i)
                cur_max = m
                continue
            micro.append(cur)
            cur, cur_max = [i], n
        if cur:
            micro.append(cur)
        for mb in micro:
            buf.append(mb)
            if len(buf) == tr["grad_accum"]:
                steps.append(buf)
                buf = []
        epoch += 1
    return steps[:n_steps]


def step_tokens(rows: List[dict], step: List[List[int]]) -> int:
    return sum(rows[i]["ids"] + rows[i]["frames"] for mb in step for i in mb)


def bucket(n: int, buckets) -> int:
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]


def padded_shape(rows: List[dict], step: List[List[int]], buckets) -> tuple:
    """(rows, length) every microbatch of the step is padded to."""
    return (max(len(mb) for mb in step),
            max(bucket(max(rows[i]["ids"] + rows[i]["frames"] for i in mb), buckets)
                for mb in step))


def write_dataset(root: str, rows: List[dict], lats: List[np.ndarray]) -> str:
    meta = os.path.join(root, "meta.jsonl")
    with open(meta, "w", encoding="utf-8") as f:
        for i, (r, z) in enumerate(zip(rows, lats)):
            path = os.path.join(root, f"{i:06d}.npy")
            np.save(path, z[None])
            f.write(json.dumps({"caption": r["text"], "vae": path}) + "\n")
    return meta


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(run: Run) -> Outcome:
    clock = Clock(run.t_start)
    clock.lap("start")  # the interpreter, imports and the harness
    tmp = tempfile.mkdtemp(prefix="perfbench-train-")
    try:
        return _run(run, clock, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run: Run, clock: Clock, tmp: str) -> Outcome:
    from kalle_tpu_torch.core.config import DataConfig, ExperimentConfig, TrainConfig
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.train.trainer import Trainer

    tr, cfg = run.traffic, run.cfg
    if tr["grad_accum"] < 2:
        raise ValueError("the harness counts an update's tokens where the trainer stacks "
                         "its microbatches: grad_accum has to be 2 or more")
    s = modelcfg.sizes(cfg)
    dev = torch.device(run.device)
    if dev.type == "cuda":
        from kalle_tpu_torch.ops.kernels import _build

        _build.build()
    clock.lap("build")

    rows = make_rows(tr, run.seed)
    meta = write_dataset(tmp, rows, latents(rows, run.seed, s["latent"]))
    clock.lap("data")

    lcfg = modelcfg.llasa_config(cfg, "train")
    train_seed = sub_seed(run.seed, 35)
    buckets = tuple(tr["length_buckets"])
    exp = ExperimentConfig(
        project_name="perfbench", exp_dir=os.path.join(tmp, "exp"), model=lcfg,
        train=TrainConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                          warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                          gradient_accumulation_steps=tr["grad_accum"],
                          audio_loss_weight=tr["audio_loss_weight"],
                          end_loss_weight=tr["end_loss_weight"],
                          log_interval=tr["log_interval"],
                          save_interval=10 ** 12, seed=train_seed),
        data=DataConfig(meta_path=meta, latent_kind="sigma",
                        max_token_length=tr["max_token_length"], batch_size=tr["batch_size"],
                        use_dynamic=True, num_workers=tr["num_workers"],
                        prefetch_size=tr["prefetch"], length_buckets=buckets))
    tok = ByteTokenizer(base_vocab=s["base_vocab"])
    n_check, n_ramp = tr["check_steps"], tr["ramp_steps"]
    open_step = n_check + n_ramp
    steps = plan(rows, tr, open_step + 64)  # extended as the window needs
    state = {"losses": [], "grad": None, "change": None, "mismatch": None,
             "batch_tokens": [], "t_open": None, "t_close": None, "open_tokens": 0,
             "window_steps": 0, "trace": None, "traced": None, "prof": None,
             "prof_s": 0.0}
    pdt = getattr(torch, cfg["train"]["param_dtype"])
    import kalle_tpu_torch.train.trainer as trainer_mod

    real_stack, real_step = trainer_mod.stack_microbatches, trainer_mod.train_step

    def stack(batches, pad_id):
        state["batch_tokens"].append(sum(int(b["ids_mask"].sum()) + int(b["audio_mask"].sum())
                                         for b in batches))
        return real_stack(batches, pad_id)

    def step_fn(tstate, *a, **k):
        m = real_step(tstate, *a, **k)
        after(tstate, tstate.step, m)
        return m

    def after(tstate, step, m):
        if step > len(steps):
            steps[:] = plan(rows, tr, 2 * step)
        plan_step = steps[step - 1]
        got, want = state["batch_tokens"][step - 1], step_tokens(rows, plan_step)
        if got != want and state["mismatch"] is None:
            state["mismatch"] = f"update {step}: {got} tokens in its batch, the plan has {want}"
        if step <= n_check:
            state["losses"].append(float(m["total_loss"]))
        if step == 1:  # AdamW's first moment after one update is (1 - b1) g
            opt = tstate.optimizer
            state["grad"] = {k: float(opt.state[p]["exp_avg"].norm() / (1 - BETA1))
                             for k, p in weights.tree_paths(tstate.params).items()}
        if step == n_check:
            cur = weights.tree_paths(tstate.params)
            change = {}
            for i, (path, *_r) in enumerate(weights.lm_leaves(s)):
                p0 = weights.lm_leaf(s, run.seed, i, dev, pdt)
                change[path] = float((cur[path].detach() - p0).float().norm())
                del p0
            state["change"] = change
        if step == open_step:
            _sync(dev)
            if dev.type == "cuda":  # the window's own peak
                torch.cuda.reset_peak_memory_stats(dev)
            clock.lap("first_steps")
            state["t_open"] = time.perf_counter()
            return
        if state["t_open"] is None:
            return
        now = time.perf_counter()
        state["open_tokens"] += got
        state["window_steps"] += 1
        k = step - open_step
        if run.trace and k == tr["trace_after_steps"]:
            state["prof"] = tracing.Profiler()
            state["prof"].start()
            state["traced"] = [step, step]  # the updates after this one, on
            state["prof_s"] += time.perf_counter() - now
        elif state["prof"] is not None and state["trace"] is None:
            state["traced"][1] = step
            if k == tr["trace_after_steps"] + tr["trace_steps"]:
                state["prof"].stop()
                state["trace"] = True
                state["prof_s"] += time.perf_counter() - now
        if now - state["t_open"] >= run.seconds:
            _sync(dev)  # the window holds every update it issued, finished
            state["t_close"] = time.perf_counter()
            raise _WindowClosed

    trainer = Trainer(exp, tok, device=dev)
    with torch.no_grad():  # the benchmark's weights into the trainer's masters
        for i, (path, *_r) in enumerate(weights.lm_leaves(s)):
            dst = weights.tree_paths(trainer.state.params)[path]
            dst.copy_(weights.lm_leaf(s, run.seed, i, dev, pdt))
    modelcfg.check_widths(cfg, lcfg, trainer.state.params)
    _sync(dev)
    clock.lap("trainer")
    trainer_mod.stack_microbatches, trainer_mod.train_step = stack, step_fn
    try:
        trainer.fit(max_steps=None)
    except _WindowClosed:
        pass
    finally:
        trainer_mod.stack_microbatches, trainer_mod.train_step = real_stack, real_step
    if state["prof"] is not None:
        if state["trace"] is None:
            state["prof"].stop()
        state["trace"] = state["prof"].trace()
    window_s = state["t_close"] - state["t_open"]
    tokens = state["open_tokens"]
    n_win = state["window_steps"]
    win_steps = steps[open_step:open_step + n_win]
    flops = sum(llasa_flops.train_row_flops(s, rows[i]["ids"] + rows[i]["frames"])
                for st in win_steps for mb in st for i in mb)
    padded = sum(len(mb) * padded_shape(rows, st, buckets)[1]
                 for st in win_steps for mb in st)
    # the profiler's start and stop are left out of the traced run's window
    ctx = {"sizes": s, "window_s": window_s - state["prof_s"], "trace": state["trace"],
           "flops": flops,
           "flash_bound_s": _flash_bound(s, rows, steps[slice(*state["traced"])]
                                         if state["traced"] else [], buckets)}
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    notes = [f"window {window_s:.3f} s, {n_win} steps, {tokens} tokens "
             f"({tokens / max(padded, 1):.4f} of the padded {padded}), "
             f"{window_s / max(n_win, 1) * 1e3:.2f} ms a step",
             f"program losses {state['losses']}"]
    if state["mismatch"]:
        notes.append(f"the plan disagrees with the trainer's batches: {state['mismatch']}")
    program = {"losses": state["losses"], "grad": state["grad"], "change": state["change"]}
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, more = check(run, s, rows, steps[:n_check], program, buckets, train_seed,
                         ok=state["mismatch"] is None)
    notes += more
    return Outcome(attempted=n_win, failed=0,
                   end_to_end={"train_tokens_per_s": tokens / window_s},
                   checks=checks, setup_split=clock.parts, context=ctx, notes=notes,
                   memory_peak_bytes=memory_peak)


def _flash_bound(s, rows, traced, buckets) -> float:
    total = 0.0
    nq, nkv, hd = s["heads"], s["kv_heads"], s["head_dim"]
    for st in traced:
        b, t = padded_shape(rows, st, buckets)
        for mb in st:
            lengths = [rows[i]["ids"] + rows[i]["frames"] for i in mb]
            total += bound_mod.seconds(flash_flops.flops_fwd(lengths, nq, hd),
                                       flash_flops.bytes_fwd(b, t, nq, nkv, hd))
            total += bound_mod.seconds(flash_flops.flops_bwd(lengths, nq, hd),
                                       flash_flops.bytes_bwd(b, t, nq, nkv, hd))
    return total * s["layers"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def lr_at(tr: dict, step: int) -> float:
    """Linear warm-up from 0 to lr over warmup_steps, then cosine decay to 0
    at total_steps, evaluated at the updates made so far."""
    warm = max(tr["warmup_steps"], 1)
    if step < warm:
        return tr["lr"] * step / warm
    decay = max(tr["total_steps"], 2) - warm
    return tr["lr"] * 0.5 * (1 + math.cos(math.pi * min(step - warm, decay) / decay))


def noise_generator(train_seed: int, step: int, micro: int, device) -> torch.Generator:
    """The input noise's generator of one microbatch, as the trainer seeds
    it from its seed + 1, the update and the microbatch."""
    mixed = (((train_seed + 1) * 1_000_003 + step) * 1_009 + micro) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def reference_steps(run: Run, s: dict, rows: List[dict], steps, buckets, train_seed: int,
                    precision: str = "f32", half_batch: bool = False) -> dict:
    """The reference's losses, first gradient norms and changes by leaf over
    `steps`. `half_batch` plants the fault of a step that leaves out half of
    each microbatch's rows and takes the mean over the rest."""
    from ..reference.llasa import Model, microbatch_loss, strict_f32

    tr = run.traffic
    dev = torch.device(run.device)
    lats = latents(rows, run.seed, s["latent"])
    with strict_f32():
        params = weights.lm_params(s, run.seed, dev, torch.float32)
        flat = weights.tree_paths(params)
        for p in flat.values():
            p.requires_grad_(True)
        model = Model(s, {"embed": params["llama"]["embed"], "layers": params["llama"]["layers"],
                          "final_norm": params["llama"]["final_norm"],
                          "audio_linear": params["audio_linear"],
                          "distribution_linear": params["distribution_linear"]}, precision)
        opt = torch.optim.AdamW(list(flat.values()), lr=tr["lr"], betas=(BETA1, BETA2), eps=EPS,
                                weight_decay=tr["weight_decay"])
        out = {"losses": [], "grad": None, "change": None}
        for k, st in enumerate(steps):
            opt.zero_grad(set_to_none=True)
            b_max, t_max = padded_shape(rows, st, buckets)
            totals = []
            for m, mb in enumerate(st):
                noise = torch.randn((b_max, t_max, s["latent"]),
                                    generator=noise_generator(train_seed, k, m, dev),
                                    device=dev, dtype=torch.float32)
                use = mb[:max(1, len(mb) // 2)] if half_batch else mb
                batch = []
                for r, i in enumerate(use):
                    n_ids, n_fr = rows[i]["ids"], rows[i]["frames"]
                    text = rows[i]["text"].encode()
                    ids = torch.tensor(list(text) + [s["base_vocab"] + 7, s["base_vocab"] + 4],
                                       device=dev)
                    if len(ids) != n_ids:
                        raise ValueError(f"row {i}: {len(ids)} ids, the plan has {n_ids}")
                    batch.append({"ids": ids,
                                  "latents": torch.as_tensor(lats[i], device=dev),
                                  "noise": noise[r, n_ids:n_ids + n_fr]})
                totals.append(microbatch_loss(model, batch, tr["end_loss_weight"],
                                              tr["audio_loss_weight"],
                                              scale=1.0 / len(st)))
            out["losses"].append(sum(totals) / len(totals))
            if k == 0:
                out["grad"] = {p: float(t.grad.norm()) for p, t in flat.items()}
            for g in opt.param_groups:
                g["lr"] = lr_at(tr, k)
            opt.step()
        with torch.no_grad():
            out["change"] = {}
            for i, (path, *_r) in enumerate(weights.lm_leaves(s)):
                p0 = weights.lm_leaf(s, run.seed, i, dev, torch.float32)
                out["change"][path] = float((flat[path] - p0).norm())
    del params, flat, model, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def gaps(got: dict, ref: dict) -> Dict[str, float]:
    """loss_gap: the worst step's |loss - reference| over the reference's;
    grad_gap and change_gap: the worst leaf's gap between the two norms,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger. Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone under Adam and are left out
    of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad = max(abs(got["grad"][k] - v) / max(v, med_g) for k, v in ref["grad"].items())
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change = max(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def check(run: Run, s, rows, steps, program, buckets, train_seed, ok: bool):
    notes = []
    ref = reference_steps(run, s, rows, steps, buckets, train_seed)
    notes.append(f"reference losses {ref['losses']}")
    got = gaps(program, ref) if ok and program["grad"] and program["change"] else \
        {"loss_gap": None, "grad_gap": None, "change_gap": None}
    if run.traffic.get("controls"):
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            other = reference_steps(run, s, rows, steps, buckets, train_seed, **kw)
            notes.append(f"{name} readings " + " ".join(
                f"{k} {v:.6g}" for k, v in gaps(other, ref).items()))
        unchanged = dict(program, change={k: 0.0 for k in program["change"]})
        notes.append("unchanged-state readings " + " ".join(
            f"{k} {v:.6g}" for k, v in gaps(unchanged, ref).items()))
    checks = {k: {"value": v, "limit": run.limits[k]} for k, v in got.items()}
    return checks, notes
