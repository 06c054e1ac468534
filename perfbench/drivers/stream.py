"""Open-loop streaming TTS through the program's HTTP handler path without
the socket: `serve/http.make_stream_fn` over one `BatcherService`, one
client thread a request in flight (as `ThreadingHTTPServer` runs one
handler a connection), Poisson arrivals at the traffic file's fixed rate.

Every seed gets the same arrival gaps and prompt lengths (mid-quantile
sets of the exponential and the lognormal), in its own order, and its own
texts. The ramp's arrivals run before the window opens and count in
set-up; the window's requests are the next `rate * seconds` arrivals, each
timed from its due time: to the first PCM chunk (TTFA) and to the last.
After the window arrivals go on until every window request has finished
(or a minute has passed), then the service is closed.

`correct`: a sample of the window's finished requests drawn from the seed,
the longest prompt among them, is run through the plain reference: the
means the server put out against the reference's over the same prompt and
fed-back frames (`frame_gap`), and every PCM chunk the client got against
the reference codec's decode of the same latent window (`pcm_gap`).
"""
from __future__ import annotations

import gc
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import modelcfg, tracing
from .. import served as served_mod
from ..common import (exponential_ppf, lognormal_int_ppf, percentile, quantile_set,
                      sub_seed, text_of)
from ..flops import llasa as llasa_flops
from ..flops import sigmavae as codec_flops
from . import Clock, Outcome, Run

@dataclass
class Request:
    index: int
    due: float                      # seconds after the open loop started
    text: str
    segment: str                    # "ramp", "window" or "tail"
    sampled: bool = False
    started: Optional[float] = None
    first: Optional[float] = None
    last: Optional[float] = None
    error: Optional[str] = None
    chunks: List[tuple] = field(default_factory=list)   # (t, new frames)
    pcm: List[bytes] = field(default_factory=list)
    completed: bool = False         # the service sent its "done" event
    done: Optional[object] = None   # the Completion, kept for sampled requests

    @property
    def finished(self) -> bool:
        return self.last is not None or self.error is not None


def schedule(traffic: dict, seed: int, seconds: float) -> List[Request]:
    """The ramp, window and tail arrivals of one run."""
    rate = float(traffic["rate_per_s"])
    lo, hi = traffic["text_chars"]
    segments = [("ramp", round(rate * traffic["ramp_s"])),
                ("window", round(rate * seconds)),
                ("tail", round(rate * traffic["tail_s"]))]
    rng = random.Random(sub_seed(seed, 11))
    total = sum(n for _, n in segments)
    lengths = quantile_set(total, lognormal_int_ppf(lo, hi))
    rng.shuffle(lengths)
    out, t = [], 0.0
    for name, n in segments:
        gaps = quantile_set(n, exponential_ppf(rate))
        rng.shuffle(gaps)
        for g in gaps:
            t += g
            out.append(Request(index=len(out), due=t, text=text_of(rng, lengths[len(out)]),
                               segment=name))
    return out


class _Local(threading.local):
    rec: Optional[Request] = None


class TeeService:
    """The BatcherService as the stream fn sees it, keeping each sampled
    request's Completion as its events pass."""

    def __init__(self, svc, local: _Local):
        self.svc, self.local = svc, local

    def submit(self, ids):
        rid, q = self.svc.submit(ids)
        return rid, _TeeQueue(q, self.local.rec)

    def close(self, join: bool = True):
        self.svc.close(join)


class _TeeQueue:
    def __init__(self, q, rec: Optional[Request]):
        self.q, self.rec = q, rec

    def get(self, *a, **k):
        ev = self.q.get(*a, **k)
        if self.rec is not None and ev is not None and ev[0] == "done":
            self.rec.completed = True
            if self.rec.sampled:
                self.rec.done = ev[1]
        return ev


def _client(stream, rec: Request, local: _Local, t0: float) -> None:
    local.rec = rec
    rec.started = time.perf_counter() - t0
    spf = stream.spf
    try:
        for pcm in stream(rec.text):
            now = time.perf_counter() - t0
            if rec.first is None:
                rec.first = now
            rec.chunks.append((now, len(pcm) // 2 // spf))
            if rec.sampled:
                rec.pcm.append(pcm)
        rec.last = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        rec.error = repr(e)


def setup_program(run: Run, clock: Clock, s: dict):
    """Kernels, weights, quantization and the service; returns (stream fn,
    service, timed codec, params, codec)."""
    from kalle_tpu_torch.data.tokens import ByteTokenizer
    from kalle_tpu_torch.serve.http import make_stream_fn
    from kalle_tpu_torch.serve.service import BatcherService

    tr = run.traffic
    dev = torch.device(run.device)
    lcfg, params, codec = served_mod.program_model(run, clock, s)
    svc = BatcherService(params, lcfg, batch_size=tr["batch"], max_frames=tr["max_frames"],
                         chunk_frames=tr["chunk_frames"],
                         prompt_buckets=tuple(tr["prompt_buckets"]),
                         seed=sub_seed(run.seed, 13), greedy=False, device=dev)
    local = _Local()
    tcodec = served_mod.TimedCodec(codec)
    tee = TeeService(svc, local)
    stream = make_stream_fn(params, lcfg, ByteTokenizer(base_vocab=s["base_vocab"]), tcodec,
                            chunk_frames=tr["chunk_frames"], max_frames=tr["max_frames"],
                            stream_ctx=tr["stream_ctx"], service=tee, device=dev)
    stream.spf = codec.samples_per_frame
    stream.local = local
    return stream, svc, tcodec, params, codec


def warm_up(run: Run, stream, codec) -> None:
    """The cell's own shapes: a prefill in each bucket its prompts reach,
    decode steps at the full batch, and the codec at every chunk window
    (1 .. chunk_frames + stream_ctx frames)."""
    tr = run.traffic
    lo, hi = tr["text_chars"]
    buckets = sorted({b for n in range(lo + 2, hi + 3)
                      for b in [min(x for x in tr["prompt_buckets"] if x >= n)]})
    texts = []
    for b in buckets:
        n = min(b - 2, hi)
        texts.append(("warm " * 40)[:n].strip().ljust(n, "a"))
    local = stream.local
    threads = []
    for i, t in enumerate(texts):
        rec = Request(index=-1 - i, due=0.0, text=t, segment="warm")
        th = threading.Thread(target=_client, args=(stream, rec, local, time.perf_counter()))
        th.start()
        threads.append((th, rec))
    for th, rec in threads:
        th.join(timeout=600)
        if rec.error:
            raise RuntimeError(f"warm-up request failed: {rec.error}")
    d = codec.cfg.latent_dim
    for n in range(1, tr["chunk_frames"] + tr["stream_ctx"] + 1):
        codec.decode_latents(np.zeros((1, n, d), np.float32))


def run(run: Run) -> Outcome:
    clock = Clock(run.t_start)
    clock.lap("start")  # the interpreter, imports and the harness
    s = modelcfg.sizes(run.cfg)
    dev = torch.device(run.device)
    stream, svc, tcodec, params, codec = setup_program(run, clock, s)
    try:
        return _serve(run, clock, s, dev, stream, svc, tcodec, params, codec)
    finally:
        svc.close()


def _serve(run, clock, s, dev, stream, svc, tcodec, params, codec) -> Outcome:
    tr = run.traffic
    warm_up(run, stream, codec)
    served_mod.sync(dev)
    clock.lap("warm_up")

    reqs = schedule(tr, run.seed, run.seconds)
    window = [r for r in reqs if r.segment == "window"]
    pick = random.Random(sub_seed(run.seed, 17))
    n_check = min(tr["check_requests"], len(window))
    longest = max(window, key=lambda r: len(r.text))
    sampled = [longest] + pick.sample([r for r in window if r is not longest], n_check - 1)
    for r in sampled:
        r.sampled = True

    # the open loop: arrivals on a thread of their own, the window's
    # bookkeeping and the profiler on this one
    t0 = time.perf_counter()
    ramp = [r for r in reqs if r.segment == "ramp"]
    open_at = ramp[-1].due if ramp else 0.0
    close_at = open_at + run.seconds
    deadline = close_at + tr["tail_s"]
    stop = threading.Event()
    threads, lateness = [], []

    def arrivals():
        for r in reqs:
            if stop.is_set():
                return
            while not stop.is_set():
                now = time.perf_counter() - t0
                if now >= r.due:
                    break
                time.sleep(min(r.due - now, 0.002))
            else:
                return
            th = threading.Thread(target=_client, args=(stream, r, stream.local, t0),
                                  daemon=True)
            th.start()
            lateness.append(time.perf_counter() - t0 - r.due)
            threads.append(th)

    def wait_until(t):
        while time.perf_counter() - t0 < t:
            time.sleep(min(0.005, max(0.0, t - (time.perf_counter() - t0))))

    gen = threading.Thread(target=arrivals, name="perfbench-arrivals", daemon=True)
    gen.start()
    wait_until(open_at)
    if dev.type == "cuda":  # the window's own peak, not set-up's
        torch.cuda.reset_peak_memory_stats(dev)
    step0, t_open = svc.cb.step_count, time.perf_counter() - t0
    clock.lap("ramp")
    prof = None
    if run.trace:
        wait_until(open_at + max(0.0, (run.seconds - tr["trace_s"]) / 2))
        prof = tracing.Profiler()
        prof.start()  # the profiler takes a while to start: time from its return
        wait_until(time.perf_counter() - t0 + tr["trace_s"])
        prof.stop()
    wait_until(close_at)
    step1, t_shut = svc.cb.step_count, time.perf_counter() - t0
    while not all(w.finished for w in window) and time.perf_counter() - t0 < deadline:
        time.sleep(0.01)
    t_done = time.perf_counter() - t0
    stop.set()
    gen.join(timeout=30)
    svc.close()
    for th in list(threads):
        th.join(timeout=30)
    steps_in_window = step1 - step0
    window_s = t_shut - t_open
    trace_obj = prof.trace() if prof is not None else None

    # end-to-end metrics over the window's requests
    # a request the service did not complete (it was closed on it) failed
    ok = [r.error is None and r.completed and r.first is not None for r in window]
    failed = [r for r, good in zip(window, ok) if not good]
    # a failed request misses every limit: it counts as waiting until the
    # run gave up on it
    ttfa = [(r.first if good else deadline) - r.due for r, good in zip(window, ok)]
    total = [(r.last if good else deadline) - r.due for r, good in zip(window, ok)]
    e2e = {"ttfa_p95_s": percentile(ttfa, 0.95), "request_p95_s": percentile(total, 0.95)}

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    # what the metric readers read
    codec_in_window = [dt for (st, dt, _n) in tcodec.calls
                       if t_open <= st - t0 <= t_shut]
    ctx = {"sizes": s, "batch": tr["batch"], "window_s": window_s, "lm_s": window_s,
           "decode_steps": steps_in_window, "codec_s": codec_in_window,
           "trace": trace_obj,
           "flops": _window_flops(s, served_mod.codec_cfg(run), reqs, t_open, t_shut, tr)}
    started = [r for r in reqs if r.started is not None and t_open <= r.started <= t_shut]
    notes = [
        f"window {window_s:.3f} s, {len(window)} requests due, {len(failed)} failed, "
        f"decode steps {steps_in_window}, the last window request done "
        f"{t_done - t_shut:.3f} s after the close",
        f"codec calls in the window {len(codec_in_window)}, mean "
        f"{1e3 * sum(codec_in_window) / max(len(codec_in_window), 1):.3f} ms; requests started "
        f"{len(started)}",
        "ttfa by third of the window (median s): " + " ".join(
            f"{percentile(part, 0.5):.4f}" for part in _thirds(ttfa)),
        f"ttfa median {percentile(ttfa, 0.5):.4f} s, request median "
        f"{percentile(total, 0.5):.4f} s",
        f"generator lateness p50 {percentile(lateness, 0.5):.6f} s p95 "
        f"{percentile(lateness, 0.95):.6f} s max {max(lateness):.6f} s over "
        f"{len(lateness)} arrivals",
        f"stop frames (served frames a request): "
        f"{sorted({sum(n for _, n in r.chunks) for r in window if r.completed})}",
    ]

    samples = [r for r in sampled if r.done is not None and r.error is None]
    del stream, svc, params, tcodec, codec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, more = check(run, s, samples, n_wanted=len(sampled))
    notes += more
    return Outcome(attempted=len(window), failed=len(failed), end_to_end=e2e,
                   checks=checks, setup_split=clock.parts, context=ctx, notes=notes,
                   memory_peak_bytes=memory_peak)


def _thirds(values):
    n = len(values)
    return [values[i * n // 3:(i + 1) * n // 3] or [float("nan")] for i in range(3)]


def _window_flops(s, codec_cfg, reqs, t_open, t_close, tr) -> float:
    """Model operations of the window's work: the prompts whose first
    chunk came in the window, every frame delivered in it (at its context),
    and the codec's decode of every chunk window in it."""
    total = 0.0
    ctx_frames = tr["stream_ctx"]
    for r in reqs:
        if not r.chunks:
            continue
        n = len(r.text.encode()) + 2
        if t_open <= r.chunks[0][0] <= t_close:
            total += llasa_flops.prefill_flops(s, n)
        start = 0
        for t, k in r.chunks:
            if t_open <= t <= t_close:
                total += sum(llasa_flops.forward_token_flops(s, n + j)
                             for j in range(start, start + k))
                total += codec_flops.decode_flops(codec_cfg, 1,
                                                  k + min(start, ctx_frames))
            start += k
    return total


def check(run: Run, s: dict, samples: List[Request], n_wanted: int):
    """The served means and PCM chunks of the sampled requests against the
    plain reference (`perfbench.served`)."""
    dev = torch.device(run.device)
    hop = math.prod(served_mod.codec_cfg(run)["strides"])
    out = []
    for r in samples:
        windows, start = [], 0
        for pcm in r.pcm:
            k = len(pcm) // 2 // hop
            audio = torch.as_tensor(np.frombuffer(pcm, "<i2").astype(np.float32) / 32767.0,
                                    device=dev)
            windows.append((max(0, start - run.traffic["stream_ctx"]), start, start + k, k,
                            audio))
            start += k
        out.append(served_mod.Served(
            ids=torch.as_tensor(served_mod.prompt_ids(r.text, s["base_vocab"]), device=dev),
            frames=torch.as_tensor(r.done.samples, device=dev, dtype=torch.float32),
            means=torch.as_tensor(r.done.means, device=dev, dtype=torch.float32),
            windows=windows))
    return served_mod.check(run, s, out, n_wanted)
