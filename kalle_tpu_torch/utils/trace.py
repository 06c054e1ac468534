"""The port's tracer: spans and counters, kept in memory.

    with trace.span("gen.step"):        # a span, when tracing is on
        ...
    trace.count("kernel.qmm")           # a counter, always on

A span records its name, an id, its parent's id (the span open around it
on the same thread), the id of its root (the outermost span open on that
thread when it began: the spans of one synthesis call or one training
update share it), the thread, its start and end on
`time.perf_counter_ns()`, and the keyword attributes it was opened with.

Tracing is off by default. Off, `span()` returns one shared object that
does nothing: no allocation, no clock read. On (`enable()`), each thread
keeps its own list of finished spans and its own stack of open ones, so the
hot path takes no lock; a span closes on the way out of its `with` block,
an exception included, and leaves the stack as it found it. No span or
counter reads a tensor or waits for the device; only `mark()` waits, and
only under a profiler.

Counters are always on and shared by the threads (a lock guards them):
the kernel wrappers count each launch under `kernel.<name>`
(`ops/kernels/_build.launches()` reads those), the trainer its tokens.
`snapshot()` copies the finished spans and the counters; `reset()` drops
both.

The tracer follows `torch.profiler`: a span opened while a profiler
session records turns tracing on (off, `span()` reads that one flag of
the profiler's). Tracing then stays on after the session ends, so that the
steps the profiler did not slow can be set beside those it did, until
`disable()`; a thread keeps at most `MAX_SPANS` finished spans. The program
calls `mark()` where it has just waited for the card (a decode step after
its stop-flag read, an update after its batch's copy to the card): while a
session records, it emits clock anchors there, each a span `trace.anchor`
around a profiler annotation (`ANCHOR`) that holds, on a card, a spin
kernel of a few hundred cycles and a synchronize. The span's two clock
readings bracket the annotation's host event and the kernel's device
event, which joins the spans to the profile on both its clocks.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List

import torch

ANCHOR = "trace:anchor"  # the profiler annotation of an anchor
ANCHORS = 2  # anchors a mark
SPIN_CYCLES = 500
MAX_SPANS = 1 << 20  # finished spans a thread keeps

_clock = time.perf_counter_ns
_on = False
_ids = itertools.count(1)
_local = threading.local()
_threads: List["_Thread"] = []  # every thread's record, for snapshot()
_counts: collections.Counter = collections.Counter()
_lock = threading.Lock()
_marks = itertools.count()
_profiling = torch._C._autograd._profiler_enabled


class _Off:
    """What `span()` gives while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Thread:
    __slots__ = ("ident", "stack", "done")

    def __init__(self):
        self.ident = threading.get_ident()
        self.stack: List[_Span] = []
        self.done: List[_Span] = []


def _thread() -> _Thread:
    rec = getattr(_local, "rec", None)
    if rec is None:
        rec = _local.rec = _Thread()
        with _lock:
            _threads.append(rec)
    return rec


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self._rec = _thread()

    def __enter__(self):
        stack = self._rec.stack
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        stack = self._rec.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # spans left open inside this one close with it
            del stack[stack.index(self):]
        if len(self._rec.done) < MAX_SPANS:
            self._rec.done.append(self)
        return False


def span(name: str, **attrs):
    """A span named `name` as a context manager; `OFF` while tracing is off
    and no profiler session records."""
    if not _on:
        if not _profiling():
            return OFF
        enable()
    return _Span(name, attrs)


def mark(device) -> None:
    """A point where the program has just waited for `device`: while a
    profiler session records, `ANCHORS` clock anchors."""
    if not _profiling():
        return
    enable()
    from torch.profiler import record_function

    cuda = torch.device(device).type == "cuda"
    k = next(_marks)
    for _ in range(ANCHORS):
        with _Span("trace.anchor", {"mark": k}):
            with record_function(ANCHOR):
                if cuda:
                    with torch.cuda.device(device):
                        torch.cuda._sleep(SPIN_CYCLES)
                    torch.cuda.synchronize(device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counts[name] += n


def counters(prefix: str = "") -> Dict[str, int]:
    """A copy of the counters whose names start with `prefix`, keyed by the
    rest of the name."""
    with _lock:
        return {k[len(prefix):]: v for k, v in _counts.items() if k.startswith(prefix)}


def clear_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still close into the record."""
    global _on
    _on = False


def reset() -> None:
    """Drop the finished spans and every counter."""
    with _lock:
        for rec in _threads:
            rec.done.clear()
        _counts.clear()


def snapshot() -> dict:
    """{"spans": [...], "counters": {...}}: each finished span as a dict
    (name, id, parent, root, thread, start_ns, end_ns, attrs), by start."""
    with _lock:
        done = [s for rec in _threads for s in list(rec.done)]
        counts = dict(_counts)
    spans = [{"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
              "thread": s._rec.ident, "start_ns": s.start_ns, "end_ns": s.end_ns,
              "attrs": dict(s.attrs)} for s in done]
    spans.sort(key=lambda s: s["start_ns"])
    return {"spans": spans, "counters": counts}
