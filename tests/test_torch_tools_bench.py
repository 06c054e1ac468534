"""The port's benches and serving tools (kalle_tpu_torch/tools/) at --tiny
--device cpu: latency_bench's four modes, http_bench with 4 requests,
serve_batch with 2 rows (plain and streaming), serve_profile and both
microbenches at one small config. The printed JSON lines carry the keys
the JAX tools print (read from their source: each `json.dumps({...})`
literal of tools/<name>.py), the wavs and HTTP bodies their lengths. The
numbers of a CPU run are the host's and say nothing of the card; here
they are only checked finite. The JAX package's flag the port has no
counterpart for (--kernel-min-batch) raises, and --device cuda raises on
a host without a card."""
import ast
import json
import os

import numpy as np
import pytest
import torch

from kalle_tpu_torch.tools import (decode_microbench, http_bench, latency_bench, serve_batch,
                                   serve_profile, train_microbench)
from kalle_tpu_torch.utils.audio import read_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = """project_name: tiny
model:
  latent_dim: 8
  audio_proj_dim: 64
  llama: {vocab_size: 265, hidden_size: 64, intermediate_size: 128, num_layers: 2,
          num_heads: 4, num_kv_heads: 2, head_dim: 16, max_seq_len: 128, dtype: float32}
"""
HDR = 44  # serve/web.wav_chunk_header


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _literals(tool: str):
    """Every dict literal printed through json.dumps in tools/<tool>.py."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", f"{tool}.py")).read())
    return [node.args[0] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


def jax_keys(tool: str):
    """The key lists of those literals, in source order."""
    return [[k.value for k in d.keys] for d in sorted(_literals(tool), key=lambda d: d.lineno)]


def _metric_keys(tool):
    """metric name -> the key list of the literal that prints it."""
    return {d.values[0].value: [k.value for k in d.keys] for d in _literals(tool)}


def _finite(line):
    for k, v in line.items():
        if isinstance(v, float):
            assert np.isfinite(v), (k, v)


TINY = ["--tiny", "--device", "cpu"]


@pytest.mark.parametrize("mode", ["ttfa", "interleave", "continuous", "poisson"])
def test_latency_bench_modes_print_the_jax_keys(capsys, mode):
    extra = {"ttfa": [], "interleave": ["--interleave"],
             "continuous": ["--continuous", "3"],
             "poisson": ["--poisson", "40,80", "--continuous", "3", "--serve-batch", "2",
                         "--chunk-frames", "2"]}[mode]
    lines = latency_bench.main(TINY + ["--iters", "2", "--max-frames", "6"] + extra)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert printed == [{k: v for k, v in x.items() if k != "decode_steps"} for x in lines]
    assert lines
    want = _metric_keys("latency_bench")
    for line in lines:
        keys = [k for k in line if k != "decode_steps"]
        if line["metric"] == "p50_time_to_first_audio_s":
            # the port's TTFA line adds p95 after value, as the interleave line has it
            keys.remove("p95")
        assert keys == want[line["metric"]], line["metric"]
        _finite(line)
    if mode in ("continuous", "poisson"):
        assert all(x["decode_steps"] >= 5 for x in lines)  # 6 frames a request
    if mode == "continuous":
        assert [x["batch"] for x in lines] == [1, 2, 4, 8, 16]
    if mode == "poisson":
        assert [x["rate_req_s"] for x in lines] == [40.0, 80.0]
        assert all(x["p50_ttfa_s"] is not None and x["requests"] == 3 for x in lines)
    if mode == "ttfa":
        assert 0 < lines[0]["value"] <= lines[0]["p95"]


def test_latency_bench_refuses_what_it_cannot_do():
    with pytest.raises(ValueError, match="no decode-attention batch gate"):
        latency_bench.main(TINY + ["--kernel-min-batch", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            latency_bench.main(["--tiny", "--iters", "1"])


def test_http_bench_streams_every_body(capsys):
    out = http_bench.main(TINY + ["--rates", "20", "--requests", "4", "--max-frames", "6",
                                  "--chunk-frames", "2", "--serve-batch", "2"])
    (line,) = out
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(printed) == jax_keys("http_bench")[0]
    assert printed == {k: v for k, v in line.items()
                       if k not in ("bodies", "decode_steps", "chunks")}
    assert line["decode_steps"] > 0 and line["chunks"] >= 5  # the warm-up and 4 requests
    assert line["errors"] == 0 and line["requests"] == 4
    hop = 8  # SigmaVAEConfig.tiny(): strides (2, 4)
    assert [len(b) for b in line["bodies"]] == [HDR + (6 - 1) * hop * 2] * 4
    assert all(b[:4] == b"RIFF" for b in line["bodies"])
    _finite(printed)


@pytest.fixture
def requests_file(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    req = tmp_path / "req.jsonl"
    req.write_text('{"id": "first", "caption": "hello there"}\n'
                   '{"id": "second", "caption": "a longer caption for this one"}\n')
    return str(cfg), str(req)


@pytest.mark.parametrize("flags", [[], ["--int8"], ["--stream", "3", "--int8", "--fused"],
                                   ["--int4", "--int8-kv"]],
                         ids=["dense", "int8", "stream_fused", "int4_int8kv"])
def test_serve_batch_writes_each_wav(tmp_path, requests_file, capsys, flags):
    cfg, req = requests_file
    out = tmp_path / "out"
    summary = serve_batch.main(["-c", cfg, "-i", req, "-o", str(out), "-m", "8", "--batch", "2",
                                "--device", "cpu"] + flags)
    lines = capsys.readouterr().out.splitlines()
    want = jax_keys("serve_batch")[0 if "--stream" in flags else 1]
    assert list(json.loads(lines[-1])) == list(summary) == want
    assert summary["requests"] == 2
    assert sorted(os.listdir(out)) == ["first.wav", "second.wav"]
    done = [x for x in lines if x.startswith("[")]
    assert len(done) == 2 and all("7 frames" in x for x in done)
    for name in ("first.wav", "second.wav"):
        raw = (out / name).read_bytes()
        assert len(raw) == HDR + 7 * 8 * 2  # 7 frames (the 8th discarded) x hop 8, int16
        if "--stream" not in flags:
            audio, sr = read_wav(str(out / name))
            assert audio.shape == (1, 7 * 8) and sr == 24000


def test_serve_profile_prints_the_jax_keys(capsys):
    line = serve_profile.main(TINY + ["--batch", "4", "--steps", "3", "--int8"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(printed) == jax_keys("serve_profile")[0]
    assert printed == {k: v for k, v in line.items() if k != "calls"}
    assert line["active_rows"] == 3 and line["steps"] == 3 and line["calls"] == 6
    assert line["kernel_min_batch"] is None and line["int8_w"] is True
    _finite(printed)


def test_decode_microbench_variants(capsys):
    lines = decode_microbench.main(TINY + ["--batch", "2", "--steps", "2", "--iters", "1",
                                           "--int8"])
    assert [x["variant"] for x in lines] == ["weights", "step", "step_nokv", "gen"]
    for x in lines:
        assert x["timing"] == "host" and x["ms_per_step"] > 0 and x["bound_by"] == "bytes"
        # one warm-up run, then iters x steps timed runs (gen: warm-up + iters)
        assert x["runs"] == (2 if x["variant"] == "gen" else 3)
        _finite(x)
    assert lines[1]["cache_len"] == 256 and lines[1]["valid_slots"] == 160
    assert lines[2]["cache_len"] == 128


def test_train_microbench_one_config(capsys):
    lines = train_microbench.main(TINY + ["--configs", "b2,t128", "b2,t128,dots,a2",
                                          "--iters", "1", "--breakdown"])
    steps = [x for x in lines if "part" not in x]
    assert [x["config"] for x in steps] == ["b2,t128", "b2,t128,dots,a2"]
    assert [x["tokens_per_step"] for x in steps] == [256, 512]
    assert [x["part"] for x in lines if "part" in x] == ["fwd", "fwd+bwd"] * 2
    for x in steps:
        assert x["peak_mem_gb"] is None and np.isfinite(x["loss"]) and x["mfu"] >= 0
    assert train_microbench.parse("b8,t512,flash,dots") == {
        "b": 8, "t": 512, "accum": 1, "flash": True, "remat": True, "policy": "dots"}
