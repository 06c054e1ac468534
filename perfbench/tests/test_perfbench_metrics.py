"""The metric arithmetic on a synthetic trace and synthetic timings, and
the operation and byte counts against shapes worked by hand."""
import json
import math

import pytest

from perfbench import harness
from perfbench.common import percentile
from perfbench.flops import bound, flash, fused_mlp, llasa, qmm, sigmavae
from perfbench.tracing import Trace, parse_chrome_trace

TINY = {"hidden": 8, "ffn": 16, "layers": 2, "heads": 2, "kv_heads": 1, "head_dim": 4,
        "latent": 2, "audio_proj": 8}


def synthetic_trace() -> Trace:
    # window 0..100 us; kernels overlap at 10-30 and 20-40; a K2 launch at
    # 50-60, K3's two kernels at 70-75 and 75-80
    dev = [(10, 30, "ampere_sgemm"), (20, 40, "elementwise"),
           (50, 60, "void (anonymous namespace)::k2::qmm_kernel<1>(...)"),
           (70, 75, "void (anonymous namespace)::k3::mlp_kernel<2>(...)"),
           (75, 80, "void (anonymous namespace)::k3::sum_kernel(...)"),
           (95, 120, "tail_kernel")]
    spans = [(41, 49, "codec"), (0, 100, "fit")]
    return Trace(window=(0.0, 100.0), device=dev, spans=spans)


def test_busy_and_idle():
    t = synthetic_trace()
    assert t.busy_intervals() == [(10, 40), (50, 60), (70, 80), (95, 100)]
    assert t.busy_s == pytest.approx(55e-6)
    assert t.window_s == pytest.approx(100e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ["fit", pytest.approx(15e-6)]  # 80-95
    assert ["codec + fit", pytest.approx(10e-6)] in gaps  # 40-50
    assert len(gaps) == 4 and sum(g[1] for g in gaps) == pytest.approx(45e-6)
    assert t.kernel_time([r"qmm_kernel"]) == (1, pytest.approx(10e-6))
    top = t.top_ops()
    assert {top[0][0], top[1][0]} == {"ampere_sgemm", "elementwise"}
    assert top[0][1] == top[1][1] == pytest.approx(20e-6)


def test_chrome_trace_roundtrip(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 5.0, "dur": 2.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 8.0, "dur": 1.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0, "dur": 3.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench:trace_window", "ts": 0.0,
           "dur": 10.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench:codec", "ts": 2.0, "dur": 1.0}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    t = parse_chrome_trace(str(p))
    assert t.window == (0.0, 10.0) and len(t.device) == 2 and t.spans == [(2.0, 3.0, "codec")]
    assert t.busy_s == pytest.approx(3e-6)


def test_readers_on_synthetic_context():
    t = synthetic_trace()
    s = dict(TINY)
    ctx = {"trace": t, "sizes": s, "batch": 4, "window_s": 2.0, "lm_s": 1.5,
           "decode_steps": 30, "codec_s": [0.010, 0.030], "flops": 989e12 * 0.5}
    r = {n: harness.load_reader(n).read(ctx) for n in (
        "lm_step_ms.synth", "codec_ms.synth", "idle_share.synth",
        "mfu.synth", "k2_roofline.synth", "k3_roofline.synth")}
    assert r["lm_step_ms.synth"] == pytest.approx(50.0)
    assert r["codec_ms.synth"] == pytest.approx(20.0)
    assert r["idle_share.synth"] == pytest.approx(45.0)
    assert r["mfu.synth"] == pytest.approx(25.0)
    per_layer = sum(bound.seconds(qmm.flops(4, k, n), qmm.nbytes(4, k, n))
                    for k, n in [(8, 8), (8, 4), (8, 4), (8, 8)])
    assert r["k2_roofline.synth"] == pytest.approx(100 * per_layer / 4 / 10e-6)
    b3 = bound.seconds(fused_mlp.flops(4, 8, 16), fused_mlp.nbytes(4, 8, 16))
    assert r["k3_roofline.synth"] == pytest.approx(100 * b3 / 10e-6)


@pytest.mark.parametrize("name,shared", [("idle_share.train", "idle_share"),
                                         ("mfu.train", "mfu"),
                                         ("flash_roofline.train", "flash_roofline"),
                                         ("lm_step_ms.stream", "lm_step_ms")])
def test_a_metric_reads_with_the_shared_reader(name, shared):
    assert harness.reader_path(name) == harness.reader_path(shared)
    assert harness.reader_path(name).name == f"{shared}.py"


def test_readers_find_nothing():
    empty = {"trace": None, "sizes": TINY, "batch": 4, "window_s": 1.0, "lm_s": 0.0,
             "decode_steps": 0, "codec_s": [], "flops": 0.0, "flash_bound_s": 0.0}
    names = [m["name"] for m in harness.benchmark_spec()["per_layer"]]
    assert all(harness.load_reader(n).read(empty) is None for n in names)


def test_percentiles():
    v = [1.0, 2.0, 3.0, 4.0, 100.0]
    assert percentile(v, 0.5) == 3.0
    assert percentile(v, 0.95) == pytest.approx(4.0 + 0.8 * 96.0)
    assert percentile([], 0.5) is None


def test_qmm_counts():
    assert qmm.flops(2, 3, 5) == 60
    # int8 weights 15 B, scales 20 B, x 12 B, y 20 B
    assert qmm.nbytes(2, 3, 5) == 67
    assert qmm.decode_projections(TINY) == [(8, 8), (8, 4), (8, 4), (8, 8)]


def test_fused_mlp_counts():
    assert fused_mlp.flops(2, 3, 5) == 180
    # three int8 weights 45 B, scales 4 * 13 B, x and y 12 B each
    assert fused_mlp.nbytes(2, 3, 5) == 45 + 52 + 24


def test_flash_counts():
    assert flash.pairs([1, 2, 3]) == 1 + 3 + 6
    assert flash.flops_fwd([2], 3, 4) == 4 * 3 * 4 * 3
    assert flash.flops_bwd([2], 3, 4) == 2 * flash.flops_fwd([2], 3, 4)
    # b 1, t 2, nq 2, nkv 1, hd 4: q (and o) 16 values, k and v 8 each
    q, kv = 1 * 2 * 2 * 4, 1 * 2 * 1 * 4
    fwd = 2 * (q + 2 * kv) + 4 * 2 + 2 * q + 4 * 2 * 2
    assert flash.bytes_fwd(1, 2, 2, 1, 4) == fwd
    bwd = 2 * (3 * q + 2 * kv) + 4 * 2 + 4 * 2 * 2 + 2 * (q + 2 * kv)
    assert flash.bytes_bwd(1, 2, 2, 1, 4) == bwd


def test_llasa_counts():
    # per layer: q 8x8, k and v 8x4, o 8x8, three 8x16
    assert llasa.layer_matmul_params(TINY) == 64 + 64 + 64 + 384
    n = 2 * 576 + 2 * 8 + 8 * 2 + 2 * 2
    assert llasa.matmul_params(TINY) == n
    assert llasa.attention_flops(TINY, 10) == 4 * 2 * 2 * 4 * 10
    assert llasa.forward_token_flops(TINY, 3) == 2 * n + 4 * 2 * 2 * 4 * 3
    assert llasa.prefill_flops(TINY, 3) == sum(llasa.forward_token_flops(TINY, c)
                                              for c in (1, 2, 3))
    assert llasa.train_row_flops(TINY, 3) == pytest.approx(
        3 * llasa.prefill_flops(TINY, 3))


def test_sigmavae_counts():
    c = {"latent_dim": 2, "strides": [2], "channels": [3, 4], "blocks_per_stage": 1,
         "mlp_ratio": 2, "kernel": 3}
    t = 5
    pre = 2 * t * 2 * 4
    block = 2 * t * (3 * 4 + 4 * 16 + 8 * 4)
    up = 2 * (t * 2) * 4 * 3 * 2
    post = 2 * (t * 2) * 3 * 3
    assert sigmavae.decode_flops(c, 2, t) == 2 * (pre + block + up + post)


def test_bound():
    assert bound.seconds(989e12, 0) == pytest.approx(1.0)
    assert bound.seconds(0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(bound.seconds(989e12, 6.7e12), 2.0)
