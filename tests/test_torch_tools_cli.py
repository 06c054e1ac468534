"""The port's scoring and checkpoint CLIs (kalle_tpu_torch/tools/) against
the JAX package's tools/ scripts, run in process on the CPU:
compute_wer's printed text equal to tools/compute_wer.py's on the same
gt/asr files (--char 0/1 x --v 0/1); convert_ckpt's pt2npz .npz equal to
the JAX tool's key by key and bit for bit, and its npz2pt state dict equal
to the JAX tool's, and ckpt2npz (the port's own checkpoints) equal to the
saved params; sim_test's per-utterance cosines on one random ECAPA_TDNN
state dict within 1e-4 of the JAX tool's (f32 on both sides; the mel
frontends agree within 1e-5, tests/test_torch_eval.py), with the same
file names; asr_test with an injected transcriber writing the JAX tool's
aaa_gt.txt / aaa_asr.txt, and exiting 1 without one."""
import importlib.util
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from kalle_tpu.eval import harness as jharness
from kalle_tpu.eval import wer as jwer
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.checkpoint import CheckpointManager
from kalle_tpu_torch.core.config import LlasaConfig, TrainConfig
from kalle_tpu_torch.data import synth_speech as sl
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.models.lm.convert import llasa_state_dict_from_params
from kalle_tpu_torch.tools import asr_test, convert_ckpt, sim_test
from kalle_tpu_torch.train.step import make_train_state
from kalle_tpu_torch.utils.audio import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = """project_name: tiny
model:
  latent_dim: 8
  audio_proj_dim: 64
  llama: {vocab_size: 265, hidden_size: 64, intermediate_size: 128, num_layers: 2,
          num_heads: 4, num_kv_heads: 2, head_dim: 16, max_seq_len: 128, dtype: float32}
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """tools/<name>.py as a module (it puts the repo root on sys.path,
    which is restored)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod


def _run_jax_main(mod, monkeypatch, argv):
    """mod.main() reads sys.argv: run it with `argv`; -> its return value."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    path = list(sys.path)
    try:
        return mod.main()
    finally:
        sys.path[:] = path


# ------------------------------------------------------------ compute_wer ----

GT = ("u1 hello world this is a test\nu2 好 的 呀 你 好\nu3 mixed 中文 words here\n"
      "u4 <unk> tagged line\nu5 only in the reference\n")
ASR = ("u1 hello word this a test extra\nu2 好 呀 你 好 吗\nu3 mixed 中 文 word here\n"
       "u4 tagged <noise> line\n")


@pytest.mark.parametrize("char", ["0", "1"])
@pytest.mark.parametrize("verbose", ["0", "1"])
def test_compute_wer_prints_the_jax_tools_text(tmp_path, capsys, monkeypatch, char, verbose):
    gt, asr = tmp_path / "gt.txt", tmp_path / "asr.txt"
    gt.write_text(GT, encoding="utf-8")
    asr.write_text(ASR, encoding="utf-8")
    argv = [f"--char={char}", f"--v={verbose}", str(gt), str(asr)]
    path = list(sys.path)
    # the JAX scorer's alignment without its native library (which it would
    # build under kalle_tpu/native/): the same choices, op for op
    monkeypatch.setattr(jwer, "_align", jwer._align_python)
    monkeypatch.setattr(sys, "argv", ["compute_wer.py"] + argv)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(os.path.join(ROOT, "tools", "compute_wer.py"), run_name="__main__")
    sys.path[:] = path
    assert e.value.code == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compute_wer"] + argv)
    with pytest.raises(SystemExit) as e:
        runpy.run_module("kalle_tpu_torch.tools.compute_wer", run_name="__main__")
    assert e.value.code == 0
    got = capsys.readouterr().out
    assert got == want and "Overall" in got
    assert ("lab:" in got) == (verbose == "1")


# ----------------------------------------------------------- convert_ckpt ----

@pytest.fixture
def tiny_cfg(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        got, ref = np.asarray(a[k]), np.asarray(b[k])
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        assert np.array_equal(got, ref), k


def test_convert_pt_npz_round_trip_matches_the_jax_tool(tmp_path, tiny_cfg, monkeypatch, capsys):
    from kalle_tpu_torch.core.config import load_experiment_config

    cfg = load_experiment_config(tiny_cfg).model
    params = llasa.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    pt = str(tmp_path / "ref.pt")
    torch.save(llasa_state_dict_from_params(params, cfg), pt)
    tool = _jax_tool("convert_ckpt")
    _run_jax_main(tool, monkeypatch, ["pt2npz", pt, str(tmp_path / "jax.npz"), "-c", tiny_cfg,
                                      "--platform", ""])
    convert_ckpt.main(["pt2npz", pt, str(tmp_path / "port.npz"), "-c", tiny_cfg,
                       "--device", "cpu"])
    _same(_npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz"))

    _run_jax_main(tool, monkeypatch, ["npz2pt", str(tmp_path / "jax.npz"),
                                      str(tmp_path / "jax.pt"), "-c", tiny_cfg, "--platform", ""])
    convert_ckpt.main(["npz2pt", str(tmp_path / "port.npz"), str(tmp_path / "port.pt"),
                       "-c", tiny_cfg, "--device", "cpu"])
    got, ref = torch.load(tmp_path / "port.pt"), torch.load(tmp_path / "jax.pt")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    # and back where it started
    orig = torch.load(pt)
    assert all(torch.equal(got[k], orig[k]) for k in orig)
    assert "wrote" in capsys.readouterr().out


def test_convert_ckpt2npz_reads_the_ports_checkpoints(tmp_path, tiny_cfg, capsys):
    from kalle_tpu_torch.core.config import load_experiment_config

    cfg = load_experiment_config(tiny_cfg).model
    out_dir = tmp_path / "run"
    mgr = CheckpointManager(str(out_dir / "torch"))
    saved = {}
    for step, seed in ((2, 4), (4, 5)):
        state = make_train_state(llasa.init_params(cfg, torch.Generator().manual_seed(seed),
                                                   "cpu"), TrainConfig())
        state.step = step
        mgr.save(step, state, wait=True)
        saved[step] = bridge.params_to_numpy(state.params)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, key) if isinstance(v, dict) else {key: v})
        return out

    convert_ckpt.main(["ckpt2npz", str(out_dir), str(tmp_path / "new.npz"), "-c", tiny_cfg,
                       "--device", "cpu"])
    assert "restored step 4" in capsys.readouterr().out
    _same(_npz(tmp_path / "new.npz"), flat(saved[4]))
    convert_ckpt.main(["ckpt2npz", str(out_dir / "torch"), str(tmp_path / "two.npz"),
                       "-c", tiny_cfg, "--step", "2", "--device", "cpu"])
    _same(_npz(tmp_path / "two.npz"), flat(saved[2]))
    with pytest.raises(FileNotFoundError):
        convert_ckpt.main(["ckpt2npz", str(tmp_path / "empty"), str(tmp_path / "x.npz"),
                           "-c", tiny_cfg, "--device", "cpu"])


# -------------------------------------------------------- sim / asr tests ----

def _ecapa_sd(seed, in_ch=80, ch=512, scale=8, pooled=1536, bottleneck=128, embd=192):
    """A random torch ECAPA_TDNN state dict at EcapaConfig()'s widths."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape, s=0.3, positive=False):
        a = s * rng.normal(size=shape)
        return torch.from_numpy((np.abs(a) + 0.5 if positive else a).astype(np.float32))

    def conv(p, cout, cin, k, bias=True):
        sd[p + ".weight"] = t(cout, cin, k, s=(cin * k) ** -0.5)
        if bias:
            sd[p + ".bias"] = t(cout)

    def lin(p, cout, cin):
        sd[p + ".weight"], sd[p + ".bias"] = t(cout, cin, s=cin ** -0.5), t(cout)

    def bn(p, c):
        sd[p + ".weight"], sd[p + ".bias"] = t(c, positive=True), t(c)
        sd[p + ".running_mean"], sd[p + ".running_var"] = t(c), t(c, positive=True)

    conv("layer1.conv", ch, in_ch, 5, bias=False)
    bn("layer1.bn", ch)
    w = ch // scale
    for n in (2, 3, 4):
        b = f"layer{n}"
        conv(f"{b}.0.conv", ch, ch, 1, bias=False)
        bn(f"{b}.0.bn", ch)
        for i in range(scale - 1):
            conv(f"{b}.1.convs.{i}", w, w, 3, bias=False)
            bn(f"{b}.1.bns.{i}", w)
        conv(f"{b}.2.conv", ch, ch, 1, bias=False)
        bn(f"{b}.2.bn", ch)
        lin(f"{b}.3.linear1", ch // 2, ch)
        lin(f"{b}.3.linear2", ch, ch // 2)
    conv("conv", pooled, 3 * ch, 1)
    conv("pooling.linear1", bottleneck, pooled, 1)
    conv("pooling.linear2", pooled, bottleneck, 1)
    bn("bn1", 2 * pooled)
    lin("linear", embd, 2 * pooled)
    bn("bn2", embd)
    return sd


def _wav_dir(root, sr=16000):
    """Two utterances: a prompt wav and a ---gen.wav each, and meta.lst."""
    os.makedirs(root, exist_ok=True)
    lines = []
    for i, text in enumerate(["hello there", "good morning"]):
        prompt = os.path.join(root, f"p{i}.wav")
        write_wav(prompt, sl.render(text, sr, speaker=i, seed=i)[None, :sr // 2], sr)
        write_wav(os.path.join(root, f"utt{i}---gen.wav"),
                  sl.render(text, sr, speaker=i + 1, seed=10 + i)[None, :sr // 2], sr)
        lines.append(f"utt{i}|{text}|{prompt}|{text}")
    meta = os.path.join(root, "meta.lst")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta


def test_sim_test_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    ckpt = str(tmp_path / "ecapa.pt")
    torch.save(_ecapa_sd(7), ckpt)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmeta, pmeta = _wav_dir(jdir), _wav_dir(pdir)
    _run_jax_main(_jax_tool("sim_test"), monkeypatch,
                  [jdir, "--meta", jmeta, "--ecapa-ckpt", ckpt, "--platform", ""])
    mean = sim_test.main([pdir, "--meta", pmeta, "--ecapa-ckpt", ckpt, "--device", "cpu"])
    want = json.load(open(os.path.join(jdir, "0000000_sim,json")))
    got = json.load(open(os.path.join(pdir, "0000000_sim,json")))
    assert sorted(got) == sorted(want) == ["utt0", "utt1"]
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    jmean = float(open(os.path.join(jdir, "0000000_sim.txt")).read())
    assert abs(float(open(os.path.join(pdir, "0000000_sim.txt")).read()) - jmean) < 1e-4
    assert abs(mean - jmean) < 1e-4
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))


def _fake_transcriber(path):
    return "Hello, " + os.path.basename(path).split("-")[0] + "!"


def test_asr_test_writes_the_jax_tools_files(tmp_path, monkeypatch, capsys):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmeta, pmeta = _wav_dir(jdir), _wav_dir(pdir)
    monkeypatch.setattr(jharness, "make_whisper_transcriber",
                        lambda model, language="en": _fake_transcriber)
    assert _run_jax_main(_jax_tool("asr_test"), monkeypatch, ["en", jdir, "--meta", jmeta]) == 0
    assert asr_test.main(["en", pdir, "--meta", pmeta], transcriber=_fake_transcriber) == 0
    for name in ("aaa_gt.txt", "aaa_asr.txt"):
        got = open(os.path.join(pdir, name)).read()
        assert got == open(os.path.join(jdir, name)).read() and got
    assert "compute_wer" in capsys.readouterr().out
    # no transcriber on the command line: the reference's back-ends need weights
    assert asr_test.main(["zh", pdir, "--meta", pmeta]) == 1
    assert "could not load ASR model" in capsys.readouterr().err
