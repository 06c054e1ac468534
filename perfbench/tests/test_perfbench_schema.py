"""BENCHMARK.json against the rules the harness is written to, the files
it names, the result line's schema and the import guard."""
import ast
import json
import re
import subprocess
import sys

import pytest

from perfbench import harness, modelcfg
from perfbench.common import HERE, ROOT, benchmark_spec, forbidden_loaded, result_line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = benchmark_spec()


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and SPEC["command"][1] == "perfbench/run.py"
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells (2 + 14 runs each) fits in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_files():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        assert any(w["config"] == c["name"] for c in SPEC["configs"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert callable(harness.load_reader(m["name"]).read)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        for cell in m["workloads"]:  # the cell reports what the metric moves
            assert cell in next(x for x in SPEC["end_to_end"]
                                if x["name"] == m["moves"]).get("workloads", [cell])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer
    for cell in cells:
        assert len(harness.cell_metrics(SPEC, cell, "end_to_end")) >= 2
        assert harness.cell_metrics(SPEC, cell, "per_layer")


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_widths_build(name):
    """The program's config carries every width of the file (weights are
    checked on the card, where the run makes them)."""
    cfg = modelcfg.load(name)
    s = modelcfg.sizes(cfg)
    for section in ("serve", "train"):
        lcfg = modelcfg.llasa_config(cfg, section)
        assert (lcfg.llama.hidden_size, lcfg.llama.num_layers, lcfg.llama.vocab_size,
                lcfg.llama.head_dim) == (s["hidden"], s["layers"], s["vocab"], s["head_dim"])
        assert lcfg.llama.rope_scaling is None and lcfg.audio_proj_dim == s["hidden"]


def test_width_check_refuses_a_cut():
    import torch

    from perfbench import weights
    from perfbench.tests import tiny

    cfg = dict(tiny.CFG)
    s = modelcfg.sizes(cfg)
    p = weights.lm_params(s, 1, "cpu", torch.float32)
    lcfg = modelcfg.llasa_config(cfg, "serve")
    modelcfg.check_widths(cfg, lcfg, p)
    with pytest.raises(ValueError):
        modelcfg.check_widths(dict(cfg, reduced=["num_hidden_layers"]), lcfg, p)
    with pytest.raises(ValueError):
        modelcfg.check_widths(dict(cfg, intermediate_size=256), lcfg, p)


def test_result_line_schema():
    line = result_line(True, 10, 1, {"setup_s": {"value": 1.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 5},
                       {"device_ops": [], "idle_gaps": []},
                       {"frame_gap": {"value": 0.1, "limit": 0.2}})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert d["checks"]["frame_gap"] == {"value": 0.1, "limit": 0.2}


def test_forbidden_names_compare_whole():
    assert forbidden_loaded(["jax.numpy", "kalle_tpu_torch.ops", "numpy"]) == ["jax"]
    assert forbidden_loaded(["kalle_tpu.core", "flax"]) == ["flax", "kalle_tpu"]
    assert forbidden_loaded(["kalle_tpu_torch", "jaxtyping"]) == []


def test_a_run_loads_no_jax():
    """The modules a synth run loads (harness, driver, program, reference)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness\n"
            "from perfbench.drivers import stream, synth, train\n"
            "from perfbench.tests import tiny\n"
            "synth.run(tiny.synth_run(seconds=0.3))\n"
            "from perfbench.common import forbidden_loaded\n"
            "print('FORBIDDEN', forbidden_loaded())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert "FORBIDDEN []" in out.stdout, out.stderr[-2000:]


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(m.split(".")[0] in ("jax", "kalle_tpu", "kalle_tpu_torch")
                               for m in mods), (path, mods)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.llasa, perfbench.reference.sigmavae\n"
            "print(sorted(m for m in sys.modules if m.startswith(('kalle', 'jax'))))\n"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_the_harness_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mistral7b.synth",
                          "--seed", str(2 ** 32 + 1), "--seconds", "1"], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""
