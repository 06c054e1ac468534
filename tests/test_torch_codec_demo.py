"""The port's codec demo entry point (counterpart of
tools/train_codec_demo.py) on the CPU at --size small: both codec kinds,
reconstruction-only and VAE-GAN, print one JSON line per eval and a last
line with the JAX tool's keys; --ckpt resumes the whole GAN state; --out
writes the tool's files. Against the tool itself: the training banks
bit-equal, and a reconstruction-only run of each kind from the tool's
initial weights printing the tool's numbers (the tool runs on the CPU in
process)."""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import oobleck as joob
from kalle_tpu.models.codecs import sigmavae as jsig
from kalle_tpu_torch import bridge
from kalle_tpu_torch.models.codecs import oobleck, sigmavae
from kalle_tpu_torch.train import codec_demo
from kalle_tpu_torch.utils.audio import read_wav

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                    "train_codec_demo.py")

# the last JSON line of tools/train_codec_demo.py
KEYS = ["snr_db", "mrstft", "holdout_snr_db", "holdout_mrstft", "steps", "size", "gan",
        "kind", "warmup_steps", "clips", "holdout_clips", "wall_s"]
FLAGS = ["--size", "small", "--clips", "3", "--holdout", "2", "--batch", "2", "--seconds",
         "0.25", "--eval-every", "1"]
SMALL = FLAGS + ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def tool():
    """tools/train_codec_demo.py as a module (it puts the repo root on
    sys.path, which is restored)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("train_codec_demo", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod


@pytest.mark.parametrize("kind", ["sigma", "oobleck"])
@pytest.mark.parametrize("gan", [False, True], ids=["recon", "gan"])
def test_demo_prints_the_tools_keys(capsys, kind, gan):
    argv = SMALL + ["--kind", kind, "--steps", "2"] + (["--gan", "--ema"] if gan else [])
    res = codec_demo.main(argv)
    lines = _lines(capsys)
    assert list(lines[-1]) == KEYS and lines[-1] == res
    assert res["kind"] == kind and res["gan"] is gan and res["steps"] == 2
    assert res["warmup_steps"] == (1 if gan else None)
    assert [r["step"] for r in lines[:-1]] == [0, 1]
    if gan:
        assert {"adv_d", "adv_g", "fm"} <= set(lines[1]) and np.isfinite(lines[1]["adv_d"])
    assert all(np.isfinite(res[k]) for k in KEYS[:4])


def test_banks_are_deterministic():
    a = codec_demo.make_bank(8000, 0.1, 4, seed=3)
    assert a.shape == (4, 800) and np.array_equal(a, codec_demo.make_bank(8000, 0.1, 4, seed=3))
    assert np.abs(a).max() <= 0.8 + 1e-6
    s = codec_demo.stereo_bank(a, 8000)
    assert s.shape == (4, 2, 800) and np.allclose(s[:, 1], 0.9 * np.roll(a, 4, axis=-1))


@pytest.mark.parametrize("sr,seconds,n,seed", [(8000, 0.1, 4, 3), (24000, 0.05, 7, 0),
                                                (16000, 0.2, 3, 777), (44100, 0.03, 6, 1)])
def test_banks_match_the_tool(tool, sr, seconds, n, seed):
    got, ref = codec_demo.make_bank(sr, seconds, n, seed), tool.make_bank(sr, seconds, n, seed)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    got_s, ref_s = codec_demo.stereo_bank(got, sr), tool.stereo_bank(ref, sr)
    assert got_s.dtype == ref_s.dtype and np.array_equal(got_s, ref_s)


def _near(got: dict, ref: dict, snr_db: float, mrstft_rtol: float):
    for k, v in ref.items():
        if k.endswith("snr_db"):
            assert abs(got[k] - v) <= snr_db + 1e-9, (k, got[k], v)
        elif k.endswith("mrstft"):
            assert abs(got[k] - v) <= mrstft_rtol * abs(v), (k, got[k], v)


class _Recorder:
    """A numpy Generator that records what its `choice` returns."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def __getattr__(self, name):
        return getattr(self._rng, name)

    def choice(self, *a, **kw):
        out = self._rng.choice(*a, **kw)
        self._log.append(np.asarray(out).tolist())
        return out


def _recording(monkeypatch, log: dict):
    """Records every draw of rng.choice (the batch order) and the cosine
    schedule's arguments, in either package."""
    import optax

    from kalle_tpu_torch.train import optim

    default_rng, cosine, adam_cosine = (np.random.default_rng, optax.cosine_decay_schedule,
                                        optim.adam_cosine)
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **kw: _Recorder(default_rng(*a, **kw), log["choice"]))

    def cosine_rec(init_value, decay_steps, alpha=0.0, *a, **kw):
        log["schedule"].append((init_value, decay_steps, alpha))
        return cosine(init_value, decay_steps, alpha, *a, **kw)

    def adam_cosine_rec(leaves, lr, steps, alpha):
        log["schedule"].append((lr, steps, alpha))
        return adam_cosine(leaves, lr, steps, alpha)

    monkeypatch.setattr(optax, "cosine_decay_schedule", cosine_rec)
    monkeypatch.setattr(optim, "adam_cosine", adam_cosine_rec)


@pytest.mark.parametrize("kind", ["sigma", "oobleck"])
def test_recon_run_matches_the_tool(tool, kind, capsys, monkeypatch, tmp_path):
    """--size small --steps 2 without --gan, the port from the tool's initial
    weights (its init at key 0, bridged): the same batches in the same
    order and the same cosine schedule (both recorded), the same bank
    (the ground-truth wav it writes is bit-equal), and the same metrics.
    After the first update the SNRs equal the tool's to their printed
    0.01 dB and the MRSTFTs within 1e-4. After the second, 0.05 dB and
    5e-3: f32 rounding alone moves the MRSTFT gradient by ~0.5% of its
    largest at that point, in either package (the log-magnitude term
    divides by the quiet bins' magnitudes; 0.37% in the port and 0.58% in
    JAX against float64 for the sigma kind), and Adam turns that into
    whole steps of lr on the elements near a zero gradient (measured:
    0.02 dB, 2.3e-3)."""
    out_ref, out_got = str(tmp_path / "ref"), str(tmp_path / "got")
    argv = FLAGS + ["--kind", kind, "--steps", "2"]
    logs = {run: {"choice": [], "schedule": []} for run in ("ref", "got")}
    jmod, tmod = (jsig, sigmavae) if kind == "sigma" else (joob, oobleck)
    jcls = jsig.SigmaVAEConfig if kind == "sigma" else joob.OobleckConfig

    def init_params(cfg, generator, device):
        jp = jmod.init_params(jcls(**dataclasses.asdict(cfg)), jax.random.key(0))
        return bridge.params_from_jax(jp, device=device)

    with monkeypatch.context() as m:
        _recording(m, logs["ref"])
        m.setattr(sys, "argv", [TOOL] + argv + ["--platform", "cpu", "--out", out_ref])
        tool.main()
    ref = _lines(capsys)
    with monkeypatch.context() as m:
        _recording(m, logs["got"])
        m.setattr(tmod, "init_params", init_params)
        res = codec_demo.main(argv + ["--device", "cpu", "--out", out_got])
    got = _lines(capsys)
    assert logs["got"] == logs["ref"] and len(logs["ref"]["choice"]) == 2
    assert logs["ref"]["schedule"] == [(1e-3, 2, 0.02)]
    assert len(got) == len(ref) == 3 and got[-1] == res
    assert [list(r) for r in got] == [list(r) for r in ref]
    assert [r["step"] for r in got[:2]] == [0, 1]
    _near(got[0], ref[0], 0.01, 1e-4)
    _near(got[1], ref[1], 0.05, 5e-3)
    _near(got[2], ref[2], 0.05, 5e-3)
    assert {k: v for k, v in got[2].items() if not k.endswith(("snr_db", "mrstft", "wall_s"))} \
        == {k: v for k, v in ref[2].items() if not k.endswith(("snr_db", "mrstft", "wall_s"))}
    wav_got, sr_got = read_wav(os.path.join(out_got, "holdout_gt0.wav"))
    wav_ref, sr_ref = read_wav(os.path.join(out_ref, "holdout_gt0.wav"))
    assert sr_got == sr_ref and np.array_equal(wav_got, wav_ref)


@pytest.mark.parametrize("kind,scale", [("sigma", 1.0), ("oobleck", 1.0), ("oobleck", 2.5)])
def test_copysyn_matches_the_tool(kind, scale):
    """`copysyn` against the tool's copy-synthesis (tools/train_codec_demo.py:
    sigma decode(encode(wav)); the Oobleck's decode of the first half of
    encode's mean||scale, both through the pretransform's scale) from the
    same weights, at the demo's small configs, 1e-5."""
    cfg, _, ratio, channels = codec_demo._codec(kind, "small", "cpu")
    cfg = dataclasses.replace(cfg, scale=scale) if kind == "oobleck" else cfg
    jmod = jsig if kind == "sigma" else joob
    jcls = jsig.SigmaVAEConfig if kind == "sigma" else joob.OobleckConfig
    jcfg = jcls(**dataclasses.asdict(cfg))
    jp = jmod.init_params(jcfg, jax.random.key(1))
    bank = codec_demo.make_bank(cfg.sample_rate, 0.05, 2, seed=5)
    t = bank.shape[-1] // ratio * ratio
    wav = codec_demo.stereo_bank(bank, cfg.sample_rate) if channels == 2 else bank[:, None]
    wav = np.ascontiguousarray(wav[..., :t])
    if kind == "sigma":
        ref = jsig.decode(jp, jcfg, jsig.encode(jp, jcfg, wav))
    else:
        ms = joob.encode(jp, jcfg, wav)
        ref = joob.decode(jp, jcfg, ms[:, :ms.shape[1] // 2])
    ref = np.asarray(ref)
    with torch.no_grad():
        got = codec_demo.copysyn(kind, cfg, bridge.params_from_jax(jp, device="cpu"),
                                 torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)


def test_demo_resumes_and_writes(capsys, tmp_path):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    codec_demo.main(SMALL + ["--gan", "--steps", "2", "--ckpt", ck])
    capsys.readouterr()
    res = codec_demo.main(SMALL + ["--gan", "--steps", "3", "--ckpt", ck, "--out", out])
    text = capsys.readouterr().out
    assert "# resumed step 2" in text and res["steps"] == 3
    assert sorted(os.listdir(out)) == ["holdout_copysyn0.wav", "holdout_gt0.wav",
                                       "sigmavae_demo.npz", "trajectory.jsonl"]
    assert sorted(os.listdir(ck)) == ["step_1.pt", "step_2.pt", "step_3.pt"]
