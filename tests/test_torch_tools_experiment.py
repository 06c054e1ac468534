"""The port's experiment chain (kalle_tpu_torch/tools/run_experiment.py)
against tools/run_experiment.py, on the CPU in f32.

Parts, against the JAX tool loaded in process: `fabricate_dataset` through
one frozen SigmaVAE (the tool's tiny codec config, the JAX init bridged to
the port) writes the same jsonl and bit-equal wavs, and latents within
1e-4 (the encoder in f32 on both sides); `latent_gate` of one random tiny
Llasa (bridged) on those rows agrees within 1e-3 relative (greedy decode,
f32: the means feed back frame to frame, so rounding grows with the
frames).

Then the whole chain through the port with tests/test_run_experiment.py's
own arguments (--tiny --steps 120 --rows 2 --seconds 1.0 --skip-wer
--codec-steps 150 --spk-steps 120), on a copy of configs/sigma_overfit.yaml
with one loader worker (two make the batch order depend on which worker
finishes first): that test's file names and gates, but for the sign of
the prompt-clone gate. With two rows the gate's pools centre to +-d, so
its "own" cosine is minus its "other" one and the gate is the sign of one
cosine between the fingerprints of 408 generated frames (past the 400 the
model saw in training) and of the prompt. That sign follows float
rounding: on this host the port's chain read +0.36, +0.23, -0.20, -0.23,
-0.004 and +0.48 at 8, 1, 2, 3, 4 and 6 threads, the JAX chain +0.037.
The test holds the gate to that identity and the chain's ok flag and exit
code to its gates, and the printed decode steps to what the chain's
generate calls take. chip_smoke.py phase 11(c) runs the JAX tiny WER
run's six rows on the card: the six mechanical gates must pass, the three
learned ones follow the draw of the frozen codec on the card and on the
CPU alike and are reported, and a witness holds the card to the CPU on
the chain's own trained LM."""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.data.tokens import build_tokenizer as jbuild_tokenizer
from kalle_tpu.infer.pipeline import Codec as JCodec
from kalle_tpu.models.codecs import sigmavae as jsig
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.data.tokens import build_tokenizer
from kalle_tpu_torch.infer.pipeline import Codec
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.tools import run_experiment
from kalle_tpu_torch.utils.audio import read_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "run_experiment.py")
# the tool's --tiny codec
CODEC = dict(latent_dim=8, sample_rate=8000, strides=(4, 5), channels=(24, 48),
             blocks_per_stage=1, fused_blocks=False, sigma=0.1)
ROWS, SECONDS = 2, 0.25


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool():
    """tools/run_experiment.py as a module (it puts the repo root on
    sys.path, which is restored)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_run_experiment", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def datasets(tool, tmp_path_factory):
    """Both tools' fabricate_dataset through one codec: (jax rows, port rows)."""
    jcfg = jsig.SigmaVAEConfig(**CODEC)
    jp = jax.tree.map(np.asarray, jsig.init_params(jcfg, jax.random.key(123)))
    root = tmp_path_factory.mktemp("fabricate")
    _, jrows = tool.fabricate_dataset(JCodec("sigma", jcfg, jp), str(root / "jax"), ROWS,
                                      SECONDS)
    codec = Codec("sigma", sigmavae.SigmaVAEConfig(**CODEC),
                  bridge.params_from_jax(jp, device="cpu"))
    _, rows = run_experiment.fabricate_dataset(codec, str(root / "port"), ROWS, SECONDS)
    return jrows, rows


def test_fabricate_dataset_matches_the_jax_tool(datasets):
    jrows, rows = datasets
    strip = lambda r: {k: v for k, v in r.items() if k not in ("vae", "speech")}  # noqa: E731
    assert [strip(r) for r in rows] == [strip(r) for r in jrows]
    for r, jr in zip(rows, jrows):
        a, sr = read_wav(r["speech"])
        b, jsr = read_wav(jr["speech"])
        assert sr == jsr == 8000 and np.array_equal(a, b)
        assert open(r["speech"], "rb").read() == open(jr["speech"], "rb").read()
        lat, jlat = np.load(r["vae"]), np.load(jr["vae"])
        assert lat.shape == jlat.shape == (int(SECONDS * 8000) // 20, 8)
        np.testing.assert_allclose(lat, jlat, atol=1e-4, rtol=1e-4)
    meta = [json.loads(x) for x in open(os.path.join(os.path.dirname(rows[0]["vae"]),
                                                     "meta.jsonl"))]
    assert meta == rows


def test_latent_gate_matches_the_jax_tool(tool, datasets):
    jrows, rows = datasets
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(vocab_size=300), latent_dim=8,
                        audio_proj_dim=64, head_variant="sigma", sigma=0.1)
    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=8,
                      audio_proj_dim=64, head_variant="sigma", sigma=0.1)
    jp = jax.tree.map(np.asarray, jllasa.init_params(jcfg, jax.random.key(5)))
    frames = int(SECONDS * 8000) // 20 + 8
    want = tool.latent_gate(jp, jcfg, jbuild_tokenizer(None), jrows, frames)
    got = run_experiment.latent_gate(bridge.params_from_jax(jp, device="cpu"), cfg,
                                     build_tokenizer(None), rows, frames)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)


def test_the_chain_at_the_jax_tests_arguments(tmp_path, capsys):
    cfg = tmp_path / "sigma_overfit.yaml"
    cfg.write_text(open(os.path.join(ROOT, "configs", "sigma_overfit.yaml")).read()
                   .replace("num_workers: 2", "num_workers: 1"))
    rc = run_experiment.main([
        str(cfg), "--tiny", "--steps", "120", "--rows", "2", "--seconds", "1.0",
        "--exp-dir", str(tmp_path), "--skip-wer", "--codec-steps", "150",
        "--spk-steps", "120", "--device", "cpu"])
    run_dir = tmp_path / "sigma-overfit-tiny"
    result = json.loads((run_dir / "experiment.json").read_text())
    gates = result["gates"]
    assert result["steps"] == 120 and result["rows"] == 2
    assert result["ok"] == all(gates.values()) and rc == (0 if result["ok"] else 1)
    assert set(gates) == {"loss_drop", "latent_gate", "checkpoint_roundtrip",
                          "all_wavs_written", "prompt_clone", "end_detection", "speaker_margin"}
    assert all(v for k, v in gates.items() if k != "prompt_clone")
    q = result["quality"]
    # two rows: the centred pools are +-d, so "other" is minus "own"
    assert np.isfinite(q["prompt_clone_sim"]) and abs(q["prompt_clone_sim"]) > 1e-6
    assert abs(q["prompt_clone_sim"] + q["prompt_clone_neg_sim"]) < 1e-6
    assert gates["prompt_clone"] == (q["prompt_clone_sim"] > q["prompt_clone_neg_sim"])
    assert q["latent_rel_mse"] < 1.0
    out_dir = result["synthesis"]["output_dir"]
    names = sorted(os.listdir(out_dir))
    for utt in ("utt000", "utt001"):
        assert f"{utt}.txt" in names
        assert f"{utt}---copysyn.wav" in names
        assert f"{utt}---gen.wav" in names
    assert "0000000_sim.txt" in names and "0000000_sim,json" in names
    assert q["end_detection_acc"] >= 0.75
    assert q["end_detection_mae_frames"] <= 2.0
    assert q["speaker_margin_pos"] - q["speaker_margin_neg"] > 0.15
    pg = sorted(os.listdir(run_dir / "prompt_gate"))
    for utt in ("utt000", "utt001"):
        assert f"{utt}---prompt.wav" in pg
        assert f"{utt}---promptgen.wav" in pg
    assert result["checkpoint"]["step"] == 120 and result["checkpoint"]["delta_vs_init"] > 0
    assert q["wer_copysyn"] is None and q["wer_gen"] is None
    # the JAX tool's keys, section by section
    assert list(result) == ["config", "tiny", "steps", "rows", "train", "checkpoint",
                            "synthesis", "quality", "gates", "ok", "total_wall_s"]
    # generate's loop steps: the sigma head never stops (its end-KL floor),
    # so infer_jsonl's one batch of two rows, the latent gate and the
    # prompt clone take max_frames (400 + 8) each; the end arm 1 to 208 a row
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "kernel launches {}"
    steps = int(lines[-2].removeprefix("decode steps "))
    assert 5 * 408 + 2 <= steps <= 5 * 408 + 2 * 208
