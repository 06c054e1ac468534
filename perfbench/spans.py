"""The program's own spans and counters (`kalle_tpu_torch/utils/trace.py`)
in a traced run, on the clock of the device trace.

The program turns its tracer on by itself: at the first point where it has
just waited for the card (a decode step after its stop-flag read, an update
after its batch's copy) and finds a `torch.profiler` session recording, in
a traced run the harness's `tracing.Profiler`. From there on it records, and
at every such point while the session records it emits clock anchors:
spans `trace.anchor` (attr `mark`, one number a point), each around a
profiler annotation (`ANCHOR`) that holds, on a card, a spin kernel of a
few hundred cycles and a synchronize. Once the run is over, the readers
take the tracer's snapshot (`program`); a program without the tracer gives
nothing, and the readers of the metrics built on it then read nothing.
The first reader to take the snapshot also prints the lines of `notes` to
standard error, after the driver's own.

The join (`join`) is measured, not assumed: each anchor's event in the
chrome trace lies inside its span's two clock readings, which bounds the
offset between the two clocks from both sides; the tightest bounds of each
mark's anchors give the offset there, and the line through the first and
the last mark's offsets carries a drift between the clocks. The trace's
device events need a join of their own: their clock can drift from the
trace's host events by several hundred parts a million in a run (as much as
a millisecond over a traced sub-window on an H100), so what is set against
device events joins through the spin kernels (`joined`), and the
annotations join the host events. Two physical checks bound the device
join once more (`clock_checks`): a `gen.flag_read` cannot end before the
device-to-host copy it waited on ends, and the first device work after that
copy (issued after the read) cannot start before the read ended.

Every reading of the program's spans leaves out the synthesis calls and
the training updates the profiler ran in: the roots that hold an anchor.
The root open when the tracer came on was never recorded, and its later
spans are roots of their own under other names. The idle shares are of the
traced sub-window itself.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

ANCHOR = "trace:anchor"  # the program's (`utils/trace.ANCHOR`)
ANCHOR_SPAN = "trace.anchor"
ANCHOR_KERNEL = "spin_kernel"  # torch.cuda._sleep's
SLACK_US = 100.0  # what the clock checks allow
ROOTS = ("synth.call", "train.update")


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from kalle_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def program(ctx: dict) -> Optional[dict]:
    """The program's snapshot (`ctx["program"]`): taken from its tracer,
    once, where the context has none yet (and its notes printed), None
    where nothing was recorded."""
    if "program" not in ctx:
        t = tracer()
        snap = t.snapshot() if t is not None else None
        ctx["program"] = snap if snap and snap["spans"] else None
        if ctx["program"] is not None:
            for line in notes(ctx):
                print(line, file=sys.stderr)
    return ctx["program"]


def anchors(snap: Optional[dict]) -> List[List[Tuple[int, int]]]:
    """The anchors' clock readings (start, end), a list for each mark, in
    order."""
    marks: Dict[int, List[Tuple[int, int]]] = {}
    for sp in (snap or {}).get("spans", []):
        if sp["name"] == ANCHOR_SPAN:
            marks.setdefault(sp["attrs"].get("mark", 0), []).append(
                (sp["start_ns"], sp["end_ns"]))
    return [sorted(marks[k]) for k in sorted(marks)]


# ---------------------------------------------------------------------------
# the clock join
# ---------------------------------------------------------------------------

@dataclass
class Join:
    """trace_us = (perf_ns + offset_ns + drift * (perf_ns - at_ns)) / 1000."""
    offset_ns: float
    drift: float
    at_ns: float
    width_ns: float  # the widest group's bracket on the offset

    def us(self, perf_ns: float) -> float:
        return (perf_ns + self.offset_ns + self.drift * (perf_ns - self.at_ns)) / 1000.0


def join(trace, marks: Sequence[Sequence[Tuple[int, int]]],
         device: bool = False) -> Optional[Join]:
    """The join of the trace's host events (`device` False: the anchors'
    annotations) or of its device events (the anchors' spin kernels) from
    the anchors' readings; None when the events and the readings do not
    pair up."""
    if trace is None or not marks:
        return None
    events = sorted((s, e) for s, e, name in trace.host if name == ANCHOR) if not device \
        else sorted((s, e) for s, e, name in trace.device if ANCHOR_KERNEL in name)
    readings = [r for group in marks for r in group]
    if len(events) != len(readings) or not readings:
        return None
    groups, i = [], 0
    for group in marks:
        lo, hi = -float("inf"), float("inf")
        for (t0, t1), (s, e) in zip(group, events[i:i + len(group)]):
            lo = max(lo, e * 1000.0 - t1)  # the event ended before the reading after it
            hi = min(hi, s * 1000.0 - t0)  # and began after the reading before it
        if lo > hi:
            return None
        groups.append((0.5 * (lo + hi), hi - lo, group[0][0]))
        i += len(group)
    (o0, _w0, t0), (o1, _w1, t1) = groups[0], groups[-1]
    drift = (o1 - o0) / (t1 - t0) if t1 > t0 else 0.0
    return Join(offset_ns=o0, drift=drift, at_ns=t0, width_ns=max(w for _o, w, _t in groups))


def joined(ctx: dict) -> Optional[Tuple[Join, List[dict]]]:
    """The join to the trace's device events (to its host events where the
    trace holds no anchor kernel: a profile of the host alone), and the
    program's spans with `s` and `e` on that clock (us); None without a
    trace, a snapshot or a join."""
    snap, trace = program(ctx), ctx.get("trace")
    if not snap or trace is None:
        return None
    device = any(ANCHOR_KERNEL in name for _s, _e, name in trace.device)
    j = join(trace, anchors(snap), device=device)
    if j is None:
        return None
    return j, [dict(sp, s=j.us(sp["start_ns"]), e=j.us(sp["end_ns"])) for sp in snap["spans"]]


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------

def profiled_roots(snap: Optional[dict]) -> set:
    """The ids of the roots the profiler ran in: those holding an anchor."""
    return {sp["root"] for sp in (snap or {}).get("spans", []) if sp["name"] == ANCHOR_SPAN}


def unprofiled_roots(ctx: dict, name: str) -> List[Tuple[dict, List[dict]]]:
    """The root spans named `name` the profiler did not run in, each with
    the spans under it (itself included)."""
    snap = program(ctx)
    if not snap:
        return []
    by_root: Dict[int, List[dict]] = {}
    for sp in snap["spans"]:
        by_root.setdefault(sp["root"], []).append(sp)
    profiled = profiled_roots(snap)
    return [(sp, by_root[sp["id"]]) for sp in snap["spans"]
            if sp["name"] == name and sp["id"] == sp["root"] and sp["id"] not in profiled]


def decode_steps(ctx: dict) -> List[Tuple[float, float]]:
    """(step ns, flag-read ns) of each `gen.step` of the unprofiled calls
    that holds one `gen.flag_read`."""
    out = []
    for _root, spans in unprofiled_roots(ctx, "synth.call"):
        flags: Dict[int, List[dict]] = {}
        for sp in spans:
            if sp["name"] == "gen.flag_read":
                flags.setdefault(sp["parent"], []).append(sp)
        for sp in spans:
            f = flags.get(sp["id"], [])
            if sp["name"] == "gen.step" and len(f) == 1:
                out.append((sp["end_ns"] - sp["start_ns"], f[0]["end_ns"] - f[0]["start_ns"]))
    return out


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The traced sub-window's stretches with no device work (us)."""
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals() for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def _union(ivs) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two sorted, disjoint interval lists."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(ivs) -> float:
    return sum(e - s for s, e in ivs)


def _thread_of(spans: List[dict], name: str) -> Optional[int]:
    return next((sp["thread"] for sp in spans if sp["name"] == name), None)


def idle_share_in(ctx: dict, names: Sequence[str], minus: Sequence[str] = (),
                  thread_of: str = "") -> Optional[float]:
    """The share (%) of the traced sub-window in which the card is idle
    while the thread that ran `thread_of` is in a span named in `names` and
    not in one named in `minus`."""
    got = joined(ctx)
    trace = ctx.get("trace")
    if got is None or trace is None or trace.window_s <= 0:
        return None
    _j, spans = got
    thread = _thread_of(spans, thread_of or names[0])
    mine = [sp for sp in spans if sp["thread"] == thread]
    inside = _union((sp["s"], sp["e"]) for sp in mine if sp["name"] in names)
    if not inside:
        return None
    out = _union((sp["s"], sp["e"]) for sp in mine if sp["name"] in minus)
    idle_inside = _intersect(idle_intervals(trace), inside)
    t = _length(idle_inside) - _length(_intersect(idle_inside, out))
    return 100.0 * t * 1e-6 / trace.window_s


def idle_by_innermost(trace, spans: List[dict], thread: int) -> Dict[str, float]:
    """Idle microseconds of the traced sub-window by the innermost span of
    `thread` open then ("none" where no span is)."""
    lo, hi = trace.window
    mine = [sp for sp in spans if sp["thread"] == thread and sp["e"] > lo and sp["s"] < hi]
    cuts = sorted({lo, hi} | {min(max(x, lo), hi) for sp in mine for x in (sp["s"], sp["e"])})
    out: Dict[str, float] = {}
    for s, e in idle_intervals(trace):
        pts = [s] + [c for c in cuts if s < c < e] + [e]
        for a, b in zip(pts, pts[1:]):
            mid = 0.5 * (a + b)
            open_ = [sp for sp in mine if sp["s"] <= mid < sp["e"]]
            name = (max(open_, key=lambda sp: (sp["s"], -sp["e"], sp["id"]))["name"]
                    if open_ else "none")
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def clock_checks(trace, spans: List[dict]) -> Optional[Tuple[float, float, int]]:
    """(worst us a flag read ended before its copy did, worst us a step's
    first device work started before the read ahead of its issue ended,
    reads compared). The reads are those of the steps that emitted anchors
    (chosen on the program's clock, so the choice owes nothing to the
    join), paired from the last with the window's last device-to-host
    copies: the profiler stops in the step after the last read. None where
    the copies are fewer or nothing is there."""
    if trace is None:
        return None
    marked = {sp["parent"] for sp in spans if sp["name"] == ANCHOR_SPAN} - {None}
    reads = sorted((sp for sp in spans if sp["name"] == "gen.flag_read"
                    and sp["parent"] in marked), key=lambda sp: sp["s"])
    w0, w1 = trace.window
    dev = sorted((s, e, n) for s, e, n in trace.device if s >= w0 and e <= w1)
    copies = sorted(((s, e) for s, e, n in dev if "DtoH" in n), key=lambda c: c[1])
    if not reads or len(copies) < len(reads):
        return None
    pairs = list(zip(reads, copies[len(copies) - len(reads):]))
    late_read = max(c[1] - r["e"] for r, c in pairs)
    early = [r["e"] - next(s for s, _e, _n in dev if s >= c[1])
             for r, c in pairs if any(s >= c[1] for s, _e, _n in dev)]
    return late_read, max(early) if early else float("nan"), len(reads)


def update_tokens(ctx: dict) -> Tuple[int, int]:
    """(real, slots): the tokens of the unprofiled updates' `train.step`
    spans (their attrs `tokens_real` and `tokens_slots`)."""
    real = slots = 0
    for _root, under in unprofiled_roots(ctx, "train.update"):
        for sp in under:
            if sp["name"] == "train.step":
                real += sp["attrs"].get("tokens_real", 0)
                slots += sp["attrs"].get("tokens_slots", 0)
    return real, slots


def host_ms(ctx: dict, root: str, profiled: bool = False) -> Tuple[int, Dict[str, float]]:
    """(roots, the mean milliseconds a root spends in each span name): over
    the roots named `root` the profiler did not run in, or over those it
    did."""
    snap = program(ctx) or {"spans": []}
    kept = {sp["id"] for sp, _u in unprofiled_roots(ctx, root)}
    roots = {sp["id"] for sp in snap["spans"] if sp["name"] == root and sp["id"] == sp["root"]
             and (sp["id"] not in kept) == profiled}
    total: Dict[str, float] = {}
    for sp in snap["spans"]:
        if sp["root"] in roots:
            total[sp["name"]] = total.get(sp["name"], 0.0) + (sp["end_ns"] - sp["start_ns"]) / 1e6
    return len(roots), {k: v / len(roots) for k, v in total.items()}


def notes(ctx: dict) -> List[str]:
    """The traced run's lines: the join and its checks; each span's host
    time in a root (`synth.call`, `train.update`) the profiler did not run
    in and in those it ran in, the unprofiled updates' tokens, and the
    counters; the traced sub-window's idle time by the innermost span of
    the program's thread."""
    snap = program(ctx)
    got = joined(ctx)
    trace = ctx.get("trace")
    if snap and got is None:
        return ["program spans: no clock join (no trace, or the anchors did not pair up)"]
    if got is None or trace is None:
        return []
    j, spans = got
    line = (f"program spans: clock join offset {j.offset_ns:.0f} ns, bracket "
            f"{j.width_ns:.0f} ns, drift {j.drift:.3g} over {len(anchors(snap))} marks")
    hj = join(trace, anchors(snap))
    if hj is not None and any(ANCHOR_KERNEL in n for _s, _e, n in trace.device):
        line += (f" (device events; the host events' offset {hj.offset_ns:.0f} ns, bracket "
                 f"{hj.width_ns:.0f} ns, drift {hj.drift:.3g})")
    if any(sp["name"] == "gen.flag_read" for sp in spans):
        checks = clock_checks(trace, spans)
        line += ("; clock checks: none (the reads and copies did not pair up)" if checks is None
                 else f"; clock checks over {checks[2]} reads: a flag read ended before its "
                      f"copy by at most {checks[0]:.1f} us, a step's first kernel started "
                      f"before its issue by at most {checks[1]:.1f} us (limit {SLACK_US:.0f})")
    root = next((r for r in ROOTS if any(sp["name"] == r for sp in spans)), ROOTS[0])
    host = []
    for profiled in (False, True):
        n, ms = host_ms(ctx, root, profiled)
        host.append(f"{'profiled' if profiled else 'unprofiled'} ({n}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(ms.items(), key=lambda x: -x[1])))
    tokens = ""
    if root == "train.update":
        real, slots = update_tokens(ctx)
        tokens = f"; the unprofiled updates' tokens {real} of {slots} slots"
    thread = next((sp["thread"] for sp in spans if sp["name"] == ANCHOR_SPAN), None)
    idle = idle_by_innermost(trace, spans, thread)
    total = sum(idle.values())
    by = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in sorted(idle.items(), key=lambda x: -x[1]))
    return [line,
            f"program host ms a {root} by span, " + "; ".join(host) + tokens
            + f"; counters {snap['counters']}",
            f"traced sub-window idle {total / 1e3:.3f} ms of "
            f"{trace.window_s * 1e3:.3f} ms by innermost program span: {by}"]
