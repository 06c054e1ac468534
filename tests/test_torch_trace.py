"""The port's tracer (`kalle_tpu_torch/utils/trace.py`): spans nested per
thread, nothing recorded, allocated or timed while off, a span closed on
an exception, the counters and the kernel launch counts they hold, the
spans `generate`, `synthesize_batch` and `Trainer.fit` record (CPU, tiny
configs), the tracer following a profiler session and its clock anchors,
and the join of the spans' clock with the profiler's trace
(`perfbench/spans.py`)."""
import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from kalle_tpu_torch.core import config
from kalle_tpu_torch.data import tokens
from kalle_tpu_torch.infer import generate as gen_mod
from kalle_tpu_torch.infer import pipeline
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.ops.kernels import _build
from kalle_tpu_torch.train import trainer as trainer_mod
from kalle_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _fresh():
    trace.disable()
    trace.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    trace.disable()
    trace.reset()


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_nesting_and_parents_on_two_threads():
    trace.enable()
    both = threading.Barrier(2)

    def work(tag):
        with trace.span("outer", tag=tag):
            both.wait(timeout=10)  # the two threads' spans interleave
            with trace.span("inner"):
                both.wait(timeout=10)
                with trace.span("leaf"):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = trace.snapshot()["spans"]
    assert len(spans) == 6 and len({s["id"] for s in spans}) == 6
    assert len({s["thread"] for s in spans}) == 2
    for tag in "ab":
        outer = next(s for s in _by_name(spans, "outer") if s["attrs"] == {"tag": tag})
        mine = [s for s in spans if s["thread"] == outer["thread"]]
        inner, leaf = _by_name(mine, "inner")[0], _by_name(mine, "leaf")[0]
        assert outer["parent"] is None
        assert inner["parent"] == outer["id"] and leaf["parent"] == inner["id"]
        assert {s["root"] for s in mine} == {outer["id"]}
        assert (outer["start_ns"] <= inner["start_ns"] <= leaf["start_ns"] <= leaf["end_ns"]
                <= inner["end_ns"] <= outer["end_ns"])
    assert [s["start_ns"] for s in spans] == sorted(s["start_ns"] for s in spans)


def test_off_records_nothing_allocates_nothing_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(trace, "_clock", clock)
    assert trace.span("gen.step") is trace.span("train.step", update=3) is trace.OFF

    def spans(n):
        for _ in range(n):
            with trace.span("gen.step"):
                with trace.span("train.step", update=3):
                    pass

    def call(name, **attrs):  # what any call of span's signature costs
        return trace.OFF

    def calls(n):
        for _ in range(n):
            with call("gen.step"):
                with call("train.step", update=3):
                    pass

    peak = {}
    for fn in (spans, calls):
        fn(100)
        tracemalloc.start()
        try:
            fn(100)
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            fn(20000)
            peak[fn] = tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
    assert peak[spans] <= peak[calls]
    assert trace.snapshot()["spans"] == []


def test_a_span_closes_on_an_exception_and_the_stack_stays_sound():
    trace.enable()
    with pytest.raises(KeyError):
        with trace.span("train.update"):
            with trace.span("train.step"):
                raise KeyError("the window closed")
    with trace.span("outer"):
        trace.span("dropped").__enter__()  # as a generator dropped mid-span leaves it
    with trace.span("after"):
        pass
    spans = trace.snapshot()["spans"]
    update, step = _by_name(spans, "train.update")[0], _by_name(spans, "train.step")[0]
    assert step["parent"] == update["id"] and step["end_ns"] <= update["end_ns"]
    after = _by_name(spans, "after")[0]
    assert after["parent"] is None and after["root"] == after["id"]
    assert not _by_name(spans, "dropped")  # never closed, so never recorded
    assert trace._thread().stack == []


def test_counters_reset_and_snapshot():
    trace.count("train.tokens_real", 5)
    trace.count("train.tokens_real")
    trace.count("kernel.qmm", 2)
    assert trace.counters() == {"train.tokens_real": 6, "kernel.qmm": 2}
    assert trace.counters("kernel.") == {"qmm": 2}
    trace.clear_counters("kernel.")
    trace.enable()
    with trace.span("x", update=1):
        pass
    trace.disable()
    trace.count("train.tokens_slots", 7)  # counters count with tracing off
    snap = trace.snapshot()
    assert snap["counters"] == {"train.tokens_real": 6, "train.tokens_slots": 7}
    (x,) = snap["spans"]
    assert x["name"] == "x" and x["attrs"] == {"update": 1} and x["end_ns"] >= x["start_ns"]
    json.dumps(snap)  # plain data
    trace.reset()
    assert trace.snapshot() == {"spans": [], "counters": {}}


def test_counters_and_spans_from_many_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work():
            for i in range(2000):
                trace.count("c")
                with trace.span("s", i=i):
                    trace.count("kernel.k", 2)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = trace.snapshot()
    assert snap["counters"] == {"c": 32000, "kernel.k": 64000}
    assert len(snap["spans"]) == 32000 and len({s["id"] for s in snap["spans"]}) == 32000


def test_launch_counts_are_the_tracers_kernel_counters():
    _build.reset_launches()
    trace.count("train.tokens_real", 3)
    _build.count("qmm")
    _build.count("qmm", 3)
    _build.count("fused_mlp")
    assert _build.launches() == {"qmm": 4, "fused_mlp": 1}
    assert trace.counters("kernel.") == {"qmm": 4, "fused_mlp": 1}
    _build.reset_launches()
    assert _build.launches() == {}
    assert trace.counters() == {"train.tokens_real": 3}


def test_generate_records_one_step_a_decode_step():
    cfg = config.LlasaConfig.tiny()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = torch.randint(0, 200, (3, 7), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    trace.enable()
    before = gen_mod.decode_steps
    gen_mod.generate(params, cfg, ids, mask, max_frames=6)
    n = gen_mod.decode_steps - before
    spans = trace.snapshot()["spans"]
    steps, flags = _by_name(spans, "gen.step"), _by_name(spans, "gen.flag_read")
    assert n == 6 and len(steps) == n  # the sigma head never stops early
    assert sorted(f["parent"] for f in flags) == sorted(s["id"] for s in steps)
    (prefill,) = _by_name(spans, "gen.prefill")
    assert prefill["end_ns"] <= min(s["start_ns"] for s in steps)


def test_synthesize_batch_spans_share_the_calls_root(tmp_path):
    tok = tokens.build_tokenizer()
    cfg = config.LlasaConfig(llama=config.LlamaConfig.tiny(vocab_size=len(tok)), latent_dim=8,
                             audio_proj_dim=64, head_variant="sigma")
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    codec = pipeline.Codec.random_init("sigma", torch.Generator().manual_seed(1), "cpu",
                                       cfg=sigmavae.SigmaVAEConfig.tiny())
    tools = pipeline.InferTools(cfg, params, tok, codec, output_root=str(tmp_path),
                                timestamp=False)
    trace.enable()
    out = tools.synthesize_batch(["one", "a second text", "three"], max_frames=4,
                                 batch_size=2)
    assert len(out) == 3
    spans = trace.snapshot()["spans"]
    (call,) = _by_name(spans, "synth.call")
    assert call["attrs"] == {"texts": 3}
    assert {s["root"] for s in spans} == {call["id"]}
    names = [s["name"] for s in spans]
    for name in ("synth.pack", "synth.unpack", "gen.prefill", "codec.decode",
                 "codec.copy_out"):
        assert names.count(name) == 2, name  # one a group
    assert names.count("gen.step") == 2 * 4
    decodes = {s["id"] for s in _by_name(spans, "codec.decode")}
    assert {s["parent"] for s in _by_name(spans, "codec.copy_out")} == decodes


def _tiny_exp(root, meta, accum):
    return config.ExperimentConfig(
        exp_dir=str(root), model=config.LlasaConfig.tiny(head_variant="sigma"),
        train=config.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=20, log_interval=2,
                                 save_interval=1000, seed=7,
                                 gradient_accumulation_steps=accum),
        data=config.DataConfig(meta_path=meta, latent_kind="sigma", batch_size=2,
                               use_dynamic=False, num_workers=1, length_buckets=(16, 32),
                               max_length=32))


def _meta(root, n=6):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = root / f"lat{i}.npy"
        np.save(path, rng.normal(size=(1, int(rng.integers(3, 14)), 8)).astype(np.float32))
        rows.append({"id": f"u{i}", "caption": "text " * (i + 1), "vae": str(path)})
    meta = root / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    return str(meta)


def test_trainer_spans_and_token_counters(tmp_path, monkeypatch):
    seen = []
    real = trainer_mod.stack_microbatches

    def stack(batches, pad_id):
        out = real(batches, pad_id)
        seen.append((sum(int(b["ids_mask"].sum()) + int(b["audio_mask"].sum())
                         for b in batches), out["input_ids"].size))
        return out

    monkeypatch.setattr(trainer_mod, "stack_microbatches", stack)
    tr = trainer_mod.Trainer(_tiny_exp(tmp_path, _meta(tmp_path), 2), tokens.build_tokenizer(),
                             device="cpu")
    trace.enable()
    tr.fit(max_steps=3)
    snap = trace.snapshot()
    spans = snap["spans"]
    updates = _by_name(spans, "train.update")
    assert [u["attrs"] for u in updates] == [{"update": k} for k in (1, 2, 3)]
    for u in updates:
        mine = [s for s in spans if s["root"] == u["id"]]
        names = [s["name"] for s in mine]
        # two batches an update; an update that runs across an epoch's end
        # also waits for the epoch's end
        assert names.count("train.data_wait") in (2, 3)
        assert names.count("train.stack") == 1 and names.count("train.step") == 1
        (step,) = _by_name(mine, "train.step")
        real, slots = seen[u["attrs"]["update"] - 1]
        assert step["attrs"] == dict(u["attrs"], tokens_real=real, tokens_slots=slots)
        assert step["parent"] == u["id"]
        under = [s["name"] for s in mine if s["parent"] == step["id"]]
        assert under.count("train.fwd_bwd") == 2 and under.count("train.optim") == 2
        assert names.count("train.log") == (u["attrs"]["update"] % 2 == 0)
    assert len(seen) == 3
    assert snap["counters"]["train.tokens_real"] == sum(r for r, _s in seen)
    assert snap["counters"]["train.tokens_slots"] == sum(s for _r, s in seen)


def test_a_profiler_session_turns_tracing_on_and_marks_anchors(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    trace.mark("cpu")  # no profiler: nothing
    assert trace.span("x") is trace.OFF and trace.snapshot()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("under", k=1):  # the first span under the profiler turns it on
            trace.mark("cpu")
        trace.mark("cpu")
    with trace.span("after"):  # and it stays on after the session
        trace.mark("cpu")  # no anchors without a session
    spans = trace.snapshot()["spans"]
    (under,) = _by_name(spans, "under")
    anchors = _by_name(spans, "trace.anchor")
    assert len(anchors) == 2 * trace.ANCHORS and _by_name(spans, "after")
    assert [a["attrs"]["mark"] - anchors[0]["attrs"]["mark"] for a in anchors] == \
        [0] * trace.ANCHORS + [1] * trace.ANCHORS
    assert all(a["parent"] == under["id"] for a in anchors[:trace.ANCHORS])
    assert all(a["parent"] is None for a in anchors[trace.ANCHORS:])
    events = [e for e in prof.events() if e.name == trace.ANCHOR]
    assert len(events) == 2 * trace.ANCHORS
    trace.disable()
    trace.reset()
    monkeypatch.setattr(trace, "MAX_SPANS", 3)  # a thread keeps at most MAX_SPANS
    trace.enable()
    for _ in range(5):
        with trace.span("capped"):
            pass
    assert len(trace.snapshot()["spans"]) == 3


def test_generate_marks_each_step_after_its_read_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    cfg = config.LlasaConfig.tiny()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = torch.randint(0, 200, (2, 5), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        gen_mod.generate(params, cfg, ids, torch.ones_like(ids), max_frames=3)
    spans = trace.snapshot()["spans"]
    steps = _by_name(spans, "gen.step")
    assert len(steps) == 3
    for st in steps:
        under = sorted((s for s in spans if s["parent"] == st["id"]), key=lambda s: s["start_ns"])
        assert [s["name"] for s in under] == ["gen.flag_read"] + ["trace.anchor"] * trace.ANCHORS
        assert len({s["attrs"]["mark"] for s in under[1:]}) == 1


def test_span_clock_joins_the_profilers_trace():
    from torch.profiler import record_function

    from perfbench import spans, tracing

    prof = tracing.Profiler()
    prof.start()
    x = torch.randn(64, 64)
    for i in range(3):
        with trace.span("marked", i=i):
            with record_function("marked_op"):
                for _ in range(20):
                    x = x @ x.T / 64.0
        trace.mark("cpu")
    prof.stop()
    ctx = {"trace": prof.trace()}
    join, joined = spans.joined(ctx)
    assert len(spans.anchors(ctx["program"])) == 3 and join.width_ns < 100_000
    events = sorted((s, e) for s, e, n in ctx["trace"].host if n == "marked_op")
    mine = sorted(_by_name(joined, "marked"), key=lambda s: s["s"])
    assert len(events) == len(mine) == 3
    for sp, (s, e) in zip(mine, events):
        assert -spans.SLACK_US <= s - sp["s"] <= spans.SLACK_US
        assert -spans.SLACK_US <= sp["e"] - e <= spans.SLACK_US
