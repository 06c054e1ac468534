"""The device trace of a traced run's sub-window, and what the metrics and
the result's `breakdown` read from it.

`Profiler` wraps `torch.profiler` (CPU and CUDA activities) around a
steady sub-window of the measured window, marked by the span
"bench:trace_window". The chrome trace it writes under the run's temporary
directory is read back once and deleted: kernel, memcpy and memset events
are the device's work; user annotations named "bench:*" are the
harness's spans, which label the idle gaps.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench:trace_window"


@dataclass
class Trace:
    window: Tuple[float, float]                 # us, the traced sub-window
    device: List[Tuple[float, float, str]]      # (start, end, name) in us
    spans: List[Tuple[float, float, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)  # host ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _clipped(self):
        lo, hi = self.window
        for s, e, n in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield s, e, n

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e, _ in sorted(self._clipped()):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_time(self, patterns: Sequence[str]) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches any
        of `patterns` (regular expressions), inside the window."""
        rx = re.compile("|".join(patterns))
        n, t = 0, 0.0
        for s, e, name in self._clipped():
            if rx.search(name):
                n += 1
                t += e - s
        return n, t * 1e-6

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, name in self._clipped():
            by[name[:200]] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest gaps with no device work, each named by the
        harness spans open at its middle, else by the longest host op
        open then ("no host op" where none is)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            names = sorted({n for a, b, n in self.spans if a <= mid <= b})
            if not names:
                ops = [(b - a, n) for a, b, n in self.host if a <= mid <= b]
                names = [max(ops)[1][:120]] if ops else ["no host op"]
            out.append([" + ".join(names), (e - s) * 1e-6])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def parse_chrome_trace(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    device, spans, host, window = [], [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((s, e, name))
        elif name == WINDOW_SPAN and cat == "user_annotation":
            window = (s, e)
        elif name.startswith("bench:") and cat == "user_annotation":
            spans.append((s, e, name[len("bench:"):]))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((s, e, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Trace(window=window, device=device, spans=spans, host=host)


class Profiler:
    """start() / stop() around the sub-window, from one thread; trace()
    then exports and parses what was recorded."""

    def __init__(self):
        self._prof = None
        self._span = None
        self.stopped = False

    @property
    def running(self) -> bool:
        return self._prof is not None and not self.stopped

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if cuda else []))
        self._prof.__enter__()
        if cuda:
            torch.cuda.synchronize()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        """End the recording; `trace()` reads it (later, off the window)."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.stopped = True

    def trace(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return parse_chrome_trace(path)
        finally:
            os.unlink(path)


def span(name: str):
    """A harness span ("bench:<name>") in the trace; a no-op when nothing
    records."""
    from torch.profiler import record_function

    return record_function(f"bench:{name}")


def kernel_seconds(trace: Optional[Trace], patterns: Sequence[str]):
    """(launches, seconds) or None without a trace or without launches."""
    if trace is None:
        return None
    n, t = trace.kernel_time(patterns)
    return (n, t) if n and t > 0 else None
