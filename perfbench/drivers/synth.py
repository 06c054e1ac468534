"""Offline batched synthesis through the program's
`infer/pipeline.InferTools.synthesize_batch`: groups of texts packed into
left-padded prompt buckets, `infer/generate.generate` at the full batch
(the int8 layer weights through K2 and K3, the cache through K1), then one
codec decode of the whole group.

Every call synthesizes `batch` texts drawn from the seed: every call of
every seed gets the same set of text lengths (mid-quantiles of the
lognormal), in its own order, and its own texts. Set-up warms up with one
whole call of the same shapes; the window then runs whole calls until
`--seconds` have passed. `synth_audio_s_per_s` is the seconds of audio all
the window's calls returned over the window's length.

The harness sees a call through thin wrappers: around the `generate` that
`synthesize_batch` calls (it keeps each call's result, on the device, with
no work added) and around the codec (each decode timed; it ends in a host
copy).

`correct`: a sample of the window's texts drawn from the seed, the
longest prompt among them, is run through the plain reference
(`perfbench.served`): the means the program served against the
reference's over the same prompt and fed-back frames (`frame_gap`), and
the audio it returned against the reference codec's decode of the same
frames (`pcm_gap`).
"""
from __future__ import annotations

import random
import shutil
import tempfile
import time
from typing import List

import numpy as np
import torch

from .. import modelcfg, tracing
from .. import served as served_mod
from ..common import lognormal_int_ppf, quantile_set, sub_seed, text_of
from ..flops import llasa as llasa_flops
from ..flops import sigmavae as codec_flops
from . import Clock, Outcome, Run


def call_texts(traffic: dict, seed: int, call: int) -> List[str]:
    """The texts of one call (call -1 is the warm-up's)."""
    rng = random.Random(sub_seed(seed, 41, call + 1))
    lengths = quantile_set(traffic["batch"], lognormal_int_ppf(*traffic["text_chars"]))
    rng.shuffle(lengths)
    return [text_of(rng, n) for n in lengths]


def batch_rows(texts: List[str], base_vocab: int) -> List[int]:
    """The text each row of the call's batch holds: `synthesize_batch`
    sorts the texts by prompt length (stably) before it packs them."""
    return sorted(range(len(texts)),
                  key=lambda i: len(served_mod.prompt_ids(texts[i], base_vocab)))


class Calls:
    """Each `generate` call's arguments and result, kept as the program
    made them."""

    def __init__(self):
        self.results: List[tuple] = []

    def wrap(self, generate):
        def capture(params, cfg, input_ids, prompt_mask, *a, **k):
            res = generate(params, cfg, input_ids, prompt_mask, *a, **k)
            self.results.append((input_ids, prompt_mask, res))
            return res
        return capture


def run(run: Run) -> Outcome:
    import kalle_tpu_torch.infer.pipeline as pipeline

    clock = Clock(run.t_start)
    clock.lap("start")  # the interpreter, imports and the harness
    calls = Calls()
    real = pipeline.generate
    tmp = tempfile.mkdtemp(prefix="perfbench-synth-")
    pipeline.generate = calls.wrap(real)
    try:
        return _run(run, clock, calls, tmp)
    finally:
        pipeline.generate = real
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run: Run, clock: Clock, calls: Calls, tmp: str) -> Outcome:
    import kalle_tpu_torch.infer.generate as gen_mod
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.infer.pipeline import InferTools

    tr = run.traffic
    s = modelcfg.sizes(run.cfg)
    dev = torch.device(run.device)
    lcfg, params, codec = served_mod.program_model(run, clock, s)
    tcodec = served_mod.TimedCodec(codec)
    tools = InferTools(lcfg, params, ByteTokenizer(base_vocab=s["base_vocab"]), tcodec,
                       output_root=tmp, timestamp=False, seed=sub_seed(run.seed, 43))
    sr = codec.cfg.sample_rate

    def synth(texts):
        return tools.synthesize_batch(texts, max_frames=tr["max_frames"],
                                      batch_size=tr["batch"],
                                      prompt_buckets=tuple(tr["prompt_buckets"]))

    t0 = time.perf_counter()
    synth(call_texts(tr, run.seed, -1))  # the warm-up: one call of the window's shapes
    warm_s = time.perf_counter() - t0
    warm_codec_s = tcodec.calls[-1][1]
    calls.results.clear()
    served_mod.sync(dev)
    clock.lap("warm_up")
    # texts enough for the window, drawn before it opens
    texts = [call_texts(tr, run.seed, c)
             for c in range(int(run.seconds / max(warm_s, 1e-3)) + 3)]

    if dev.type == "cuda":  # the window's own peak, not set-up's
        torch.cuda.reset_peak_memory_stats(dev)
    # the traced run profiles decode steps in the middle of one call: the
    # second call where the window holds two or more
    traced = min(1, int(run.seconds / max(warm_s, 1e-3))) if run.trace else -1
    prof = tracing.Profiler() if run.trace else None
    head = gen_mod._head_step
    records, audio = [], []
    t_open = time.perf_counter()
    while True:
        c = len(records)
        if c == len(texts):
            texts.append(call_texts(tr, run.seed, c))
        if c == traced:
            gen_mod._head_step = _profiled(head, prof, tr["trace_from_step"], tr["trace_steps"])
        steps0, n_codec = gen_mod.decode_steps, len(tcodec.calls)
        t1 = time.perf_counter()
        out = synth(texts[c])
        t2 = time.perf_counter()
        gen_mod._head_step = head
        if c == traced and prof.running:  # the call ended before the traced steps did
            prof.stop()
        records.append({"s": t2 - t1, "steps": gen_mod.decode_steps - steps0,
                        "codec_s": sum(x[1] for x in tcodec.calls[n_codec:]),
                        "audio_s": sum(a.shape[-1] for a in out) / sr, "traced": c == traced})
        audio.append(out)
        if t2 - t_open >= run.seconds:
            break
    window_s = time.perf_counter() - t_open
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    trace_obj = prof.trace() if traced >= 0 and prof.stopped else None
    audio_s = sum(r["audio_s"] for r in records)

    # the per-layer readings leave out the call the profiler ran in
    plain = [(r, i) for i, r in enumerate(records) if not r["traced"]] or \
        [(r, i) for i, r in enumerate(records)]
    flops = sum(_call_flops(s, served_mod.codec_cfg(run), tr, texts[i], calls.results[i][2])
                for _r, i in plain)
    ctx = {"sizes": s, "batch": tr["batch"], "trace": trace_obj,
           "window_s": sum(r["s"] for r, _i in plain), "flops": flops,
           "lm_s": sum(r["s"] - r["codec_s"] for r, _i in plain),
           "decode_steps": sum(r["steps"] for r, _i in plain),
           "codec_s": [r["codec_s"] for r, _i in plain]}
    stops = sorted({int(n) for *_x, res in calls.results for n in res.n_frames.tolist()})
    notes = [
        f"window {window_s:.3f} s, {len(records)} calls of {tr['batch']} texts, "
        f"{audio_s:.3f} s of audio; a call {_join(records, 's')} s, its codec decode "
        f"{_join(records, 'codec_s')} s, decode steps {_join(records, 'steps')}",
        f"warm-up call {warm_s:.3f} s (codec {warm_codec_s:.3f} s)",
        f"stop frames (n_frames a row): {stops}",
        f"window memory peak {memory_peak} bytes",
    ]

    served, n_wanted, bad = _sampled(run, s, texts, records, calls, audio)
    del tools, params, codec, tcodec, audio
    calls.results.clear()
    served_mod.free(dev)
    checks, more = served_mod.check(run, s, served, n_wanted)
    if bad:
        notes.append(f"prompts served otherwise than the texts: {bad}")
        checks = {k: dict(c, value=None) for k, c in checks.items()}
    notes += more
    return Outcome(attempted=len(records) * tr["batch"], failed=0,
                   end_to_end={"synth_audio_s_per_s": audio_s / window_s},
                   checks=checks, setup_split=clock.parts, context=ctx, notes=notes,
                   memory_peak_bytes=memory_peak)


def _join(records, key) -> str:
    return ", ".join(f"{r[key]:.3f}" if isinstance(r[key], float) else str(r[key])
                     for r in records)


def _profiled(head, prof, first: int, n: int):
    """`generate`'s head step, with the profiler on from step `first` for
    `n` steps (started and stopped on the program's own thread, between
    steps)."""
    count = [0]

    def step(*a, **k):
        if count[0] == first:
            prof.start()
        elif count[0] == first + n:
            prof.stop()
        count[0] += 1
        return head(*a, **k)
    return step


def _call_flops(s, ccfg, tr, texts, res) -> float:
    """Model operations of one call: each text's prompt prefilled, each
    frame it was served decoded at its context, and the codec's decode of
    the whole batch."""
    total = 0.0
    n_frames = res.n_frames.tolist()
    for row, i in enumerate(batch_rows(texts, s["base_vocab"])):
        n, n_fr = len(texts[i].encode()) + 2, n_frames[row]
        total += llasa_flops.prefill_flops(s, n)
        total += sum(llasa_flops.forward_token_flops(s, n + j) for j in range(int(n_fr) + 1))
    return total + codec_flops.decode_flops(ccfg, tr["batch"], tr["max_frames"])


def _sampled(run, s, texts, records, calls, audio):
    """The sampled texts of the window as `Served` requests, the count
    wanted, and the texts whose prompt row the program filled otherwise."""
    tr = run.traffic
    dev = torch.device(run.device)
    pool = [(c, i) for c in range(len(records)) for i in range(tr["batch"])]
    longest = max(pool, key=lambda ci: (len(texts[ci[0]][ci[1]]), -ci[0], -ci[1]))
    rest = [ci for ci in pool if ci != longest]
    pick = [longest] + random.Random(sub_seed(run.seed, 47)).sample(
        rest, min(tr["check_rows"], len(pool)) - 1)
    out, bad = [], []
    for c, i in pick:
        ids_in, mask_in, res = calls.results[c]
        row = batch_rows(texts[c], s["base_vocab"]).index(i)
        want = served_mod.prompt_ids(texts[c][i], s["base_vocab"])
        got = ids_in[row][mask_in[row].bool()].cpu().numpy()
        if not np.array_equal(got, want):
            bad.append((c, i))
        n = int(res.n_frames[row])
        keep = max(n, 1)
        out.append(served_mod.Served(
            ids=torch.as_tensor(want, device=dev),
            frames=res.samples[row].float().clone(),
            means=res.means[row, :n + 1].float().clone(),
            windows=[(0, 0, tr["max_frames"], keep,
                      torch.as_tensor(audio[c][i][0], device=dev))]))
    return out, len(pick), bad
