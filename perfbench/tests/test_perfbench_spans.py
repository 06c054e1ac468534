"""The readers of the program's spans and counters (`perfbench/spans.py`)
on hand-built snapshots and synthetic traces: the clock join through the
anchors, each of the six readers with exact values, nothing read where a
record is absent, idle by innermost span, the clock checks and the notes."""
import pytest

from perfbench import harness, spans
from perfbench.tracing import Trace

OFFSET_NS = 7000  # the program's clock = the trace's (us) * 1000 + OFFSET_NS
READERS = ("step_issue_ms.synth", "flag_wait_ms.synth", "issue_idle.synth",
           "data_wait_ms.train", "pad_share.train", "input_idle.train")


def _ns(us):
    return int(us * 1000) + OFFSET_NS


def _sp(i, name, parent, root, s_ns, e_ns, **attrs):
    return {"name": name, "id": i, "parent": parent, "root": root, "thread": 1,
            "start_ns": s_ns, "end_ns": e_ns, "attrs": attrs}


# two marks of two anchors each, read exactly: (start us, end us, mark)
SYNTH_ANCHORS = [(21.0, 21.5, 0), (22.0, 22.5, 0), (46.0, 46.5, 1), (47.0, 47.5, 1)]
TRAIN_ANCHORS = [(22.0, 22.5, 0), (23.0, 23.5, 0), (60.0, 60.5, 1), (61.0, 61.5, 1)]


def _anchor_spans(first_id, anchors, parents, root):
    return [_sp(first_id + k, spans.ANCHOR_SPAN, parents[m], root, _ns(s), _ns(e), mark=m)
            for k, (s, e, m) in enumerate(anchors)]


def program_trace(anchors=SYNTH_ANCHORS) -> Trace:
    # window 0..100 us; the flag reads' copies at 18-20 and 42-44; busy
    # 0-12, 18-20, 25-30, 42-60; the anchors' annotations
    copy = "Memcpy DtoH (Device -> Pageable)"
    dev = [(0, 12, "k"), (18, 20, copy), (25, 30, "k"), (42, 44, copy), (44, 60, "k")]
    host = [(s, e, spans.ANCHOR) for s, e, _m in anchors]
    return Trace(window=(0.0, 100.0), device=dev, host=host)


def synth_context() -> dict:
    sp = [
        # the profiled call: steps at 10-40 and 40-70 us, flag reads 10-20,
        # 40-45, each followed by its step's anchors
        _sp(10, "synth.call", None, 10, _ns(0), _ns(100)),
        _sp(11, "gen.step", 10, 10, _ns(10), _ns(40)),
        _sp(12, "gen.flag_read", 11, 10, _ns(10), _ns(20)),
        _sp(13, "gen.step", 10, 10, _ns(40), _ns(70)),
        _sp(14, "gen.flag_read", 13, 10, _ns(40), _ns(45)),
        # a call outside the trace: steps of 20 us, reads of 8 and 4 us
        _sp(1, "synth.call", None, 1, 200_000, 300_000),
        _sp(2, "gen.step", 1, 1, 210_000, 230_000),
        _sp(3, "gen.flag_read", 2, 1, 210_000, 218_000),
        _sp(4, "gen.step", 1, 1, 230_000, 250_000),
        _sp(5, "gen.flag_read", 4, 1, 230_000, 234_000),
    ] + _anchor_spans(50, SYNTH_ANCHORS, {0: 11, 1: 13}, 10)
    return {"trace": program_trace(), "program": {"spans": sp, "counters": {}}}


def train_context() -> dict:
    sp = [
        _sp(40, "train.update", None, 40, _ns(0), _ns(100), update=3),  # profiled
        _sp(41, "train.data_wait", 40, 40, _ns(12), _ns(18)),
        _sp(42, "train.stack", 40, 40, _ns(18), _ns(22)),
        _sp(43, "train.step", 40, 40, _ns(24), _ns(90), update=3, tokens_real=999,
            tokens_slots=1000),
        _sp(20, "train.update", None, 20, 300_000, 400_000, update=4),
        _sp(21, "train.data_wait", 20, 20, 300_000, 302_000),
        _sp(22, "train.data_wait", 20, 20, 305_000, 306_000),
        _sp(23, "train.stack", 20, 20, 306_000, 308_000),
        _sp(24, "train.step", 20, 20, 308_000, 390_000, update=4, tokens_real=100,
            tokens_slots=150),
        _sp(30, "train.update", None, 30, 400_000, 500_000, update=5),
        _sp(31, "train.data_wait", 30, 30, 400_000, 401_000),
        _sp(32, "train.step", 30, 30, 401_000, 490_000, update=5, tokens_real=200,
            tokens_slots=250),
    ] + _anchor_spans(60, TRAIN_ANCHORS, {0: 40, 1: 40}, 40)
    return {"trace": program_trace(TRAIN_ANCHORS),
            "program": {"spans": sp,
                        "counters": {"train.tokens_real": 1299, "train.tokens_slots": 1400}}}


def test_the_clock_join_is_read_from_the_anchors():
    marks = spans.anchors(synth_context()["program"])
    assert marks == [[(_ns(21.0), _ns(21.5)), (_ns(22.0), _ns(22.5))],
                     [(_ns(46.0), _ns(46.5)), (_ns(47.0), _ns(47.5))]]
    j = spans.join(program_trace(), marks)
    assert j.offset_ns == -OFFSET_NS and j.drift == 0.0 and j.width_ns == 0.0
    assert j.us(_ns(42.0)) == pytest.approx(42.0)
    # an anchor missing from the trace, or readings that cannot hold its event
    assert spans.join(program_trace(), [marks[0]]) is None
    assert spans.join(program_trace(), [[(_ns(21.2), _ns(21.5)), marks[0][1]], marks[1]]) is None


def test_program_span_readers_on_synthetic_records():
    synth, train = synth_context(), train_context()
    got = {n: harness.load_reader(n).read(synth) for n in READERS[:3]}
    # the unprofiled call's steps: self times 12 and 16 us, reads 8 and 4 us
    assert got["step_issue_ms.synth"] == pytest.approx(0.014)
    assert got["flag_wait_ms.synth"] == pytest.approx(0.006)
    # idle while issuing (20-40 and 45-70 us): 20-25, 30-40, 60-70 of 100
    # us, less the anchors at 21-21.5 and 22-22.5
    assert got["issue_idle.synth"] == pytest.approx(24.0)
    got = {n: harness.load_reader(n).read(train) for n in READERS[3:]}
    assert got["data_wait_ms.train"] == pytest.approx(0.002)  # (3 + 1) / 2 us
    assert got["pad_share.train"] == pytest.approx(25.0)  # 1 - 300 / 400
    assert got["input_idle.train"] == pytest.approx(8.0)  # 12-18 and 20-22 us


def test_program_span_readers_find_nothing_without_their_records():
    no_program = {"trace": program_trace(), "program": None}
    assert all(harness.load_reader(n).read(no_program) is None for n in READERS)
    other = {"synth": synth_context(), "train": train_context()}
    for n in READERS:  # a cell's records hold nothing for the other cell's metrics
        ctx = other["train" if n.endswith(".synth") else "synth"]
        assert harness.load_reader(n).read(ctx) is None, n
    ctx = synth_context()
    unjoined = dict(ctx, program=dict(ctx["program"], spans=[
        sp for sp in ctx["program"]["spans"] if sp["name"] != spans.ANCHOR_SPAN]))
    assert harness.load_reader("issue_idle.synth").read(unjoined) is None
    # without anchors no call is known to be profiled: both calls are read
    assert harness.load_reader("flag_wait_ms.synth").read(unjoined) == pytest.approx(0.00675)


def test_the_snapshot_comes_from_the_program_s_tracer(capsys):
    trace = spans.tracer()
    trace.disable()
    trace.reset()
    assert spans.program({"trace": program_trace()}) is None  # nothing recorded
    trace.enable()
    try:
        with trace.span("synth.call"):
            with trace.span("gen.step"):
                with trace.span("gen.flag_read"):
                    pass
    finally:
        trace.disable()
    ctx = {"trace": None}
    snap = spans.program(ctx)
    assert [sp["name"] for sp in snap["spans"]] == ["synth.call", "gen.step", "gen.flag_read"]
    assert ctx["program"] is snap and spans.program(ctx) is snap  # taken once
    assert "no clock join" in capsys.readouterr().err
    trace.reset()


def test_idle_by_innermost_span_and_the_clock_checks():
    ctx = synth_context()
    join, joined = spans.joined(ctx)
    idle = spans.idle_by_innermost(ctx["trace"], joined, 1)
    # idle 12-18, 20-25, 30-42, 60-100 us: the reads hold 12-18 and 40-42,
    # the anchors 21-21.5 and 22-22.5
    assert idle == pytest.approx({"gen.step": 24.0, "gen.flag_read": 8.0, "synth.call": 30.0,
                                  spans.ANCHOR_SPAN: 1.0})
    # the reads end at 20 and 45 us, their copies at 20 and 44, the device's
    # next work starts at 25 and 44
    late_read, early_kernel, n = spans.clock_checks(ctx["trace"], joined)
    assert (late_read, early_kernel, n) == (pytest.approx(0.0), pytest.approx(1.0), 2)
    # a copy before the first marked read (its step's read, made before
    # the tracer came on) is left out: the pairs run from the last
    early = Trace(window=(0.0, 100.0), device=[(5, 6, "Memcpy DtoH")] + ctx["trace"].device,
                  host=ctx["trace"].host)
    assert spans.clock_checks(early, joined) == (pytest.approx(0.0), pytest.approx(1.0), 2)
    one_copy = Trace(window=(0.0, 100.0), device=ctx["trace"].device[:3], host=ctx["trace"].host)
    assert spans.clock_checks(one_copy, joined) is None
    lines = spans.notes(ctx)
    assert len(lines) == 3 and "copy by at most 0.0 us" in lines[0] and "2 marks" in lines[0]
    # the unprofiled call: 100 us, two steps of 20, reads of 8 and 4
    assert ("unprofiled (1): synth.call 0.100, gen.step 0.040, gen.flag_read 0.012; "
            "profiled (1): synth.call 0.100, gen.step 0.060, gen.flag_read 0.015, "
            "trace.anchor 0.002") in lines[1]
    assert "idle 0.063 ms of 0.100 ms" in lines[2] and "gen.step 0.024 ms" in lines[2]
    train = spans.notes(train_context())
    assert "a train.update by span, unprofiled (2)" in train[1]
    assert "the unprofiled updates' tokens 300 of 400 slots" in train[1]


def test_spans_join_the_device_events_through_the_anchor_kernels():
    # the trace's device clock runs 0.1% fast against its host events, 2 us
    # ahead at 1 us: the spans go onto the device events' clock
    dev_at = lambda us: us + 2.0 + 1e-3 * (us - 1.0)  # noqa: E731
    t = program_trace()
    t.device += [(dev_at(s) + 0.1, dev_at(e) - 0.1, "at::cuda::spin_kernel(long)")
                 for s, e, _m in SYNTH_ANCHORS]
    marks = spans.anchors(synth_context()["program"])
    host = spans.join(t, marks)
    dev = spans.join(t, marks, device=True)
    assert host.offset_ns == -OFFSET_NS and host.drift == 0.0
    # each mark's bracket holds its anchors, which the drift spreads by 1.5 ns
    assert dev.offset_ns == pytest.approx(-OFFSET_NS + 2020.75, abs=0.01)
    assert dev.drift == pytest.approx(1e-3, rel=1e-3) and dev.width_ns == pytest.approx(198.5)
    ctx = dict(synth_context(), trace=t)
    j, joined = spans.joined(ctx)
    assert j == dev
    read = next(sp for sp in joined if sp["id"] == 12)
    assert read["s"] == pytest.approx(dev_at(10.0), abs=0.005)
    assert read["e"] == pytest.approx(dev_at(20.0), abs=0.005)
    assert "the host events' offset -7000 ns" in spans.notes(ctx)[0]
