"""The port's mid-training listening hook (kalle_tpu_torch/train/
eval_hook.py) against the JAX package's (kalle_tpu/train/eval_hook.py) on
the same weights, batch and tiny f32 SigmaVAE, on the CPU.

`-gt.wav` (the batch's latents through the codec), `-gen.txt` and the
`-gt2.wav` copy must agree as they are (wav 1e-4). `-gen.wav` depends on
the forward's input noise, which the two packages draw from different
generators: it is held with one N(0, 1) draw injected as `latent_noise` on
both sides (pytest's monkeypatch on each package's `llasa.forward`, undone
after the test). The sigma sampling of the predicted means draws from
`np.random.default_rng(step)` in both packages, unpatched.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.infer import pipeline as jpipeline
from kalle_tpu.models.codecs import sigmavae as jvae
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.train import eval_hook as jeval_hook
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.data import collate, tokens
from kalle_tpu_torch.infer import pipeline
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.train import eval_hook
from kalle_tpu_torch.train.trainer import Trainer
from kalle_tpu_torch.utils.audio import read_wav, write_wav

STEP = 7


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    tok = tokens.build_tokenizer()
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(vocab_size=len(tok)), latent_dim=8,
                        audio_proj_dim=64, head_variant="sigma")
    cfg = config.LlasaConfig(llama=config.LlamaConfig.tiny(vocab_size=len(tok)),
                             latent_dim=8, audio_proj_dim=64, head_variant="sigma")
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    jcodec = jpipeline.Codec.random_init("sigma", cfg=jvae.SigmaVAEConfig.tiny())
    host = lambda tree: bridge.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    codec = pipeline.Codec("sigma", sigmavae.SigmaVAEConfig.tiny(), host(jcodec.params))
    return tok, (jcfg, jp, jcodec), (cfg, host(jp), codec)


@pytest.fixture
def batch(models, tmp_path):
    tok = models[0]
    rng = np.random.default_rng(3)
    src = str(tmp_path / "source.wav")
    write_wav(src, 0.1 * rng.normal(size=(1, 2400)).astype(np.float32), 24000)
    items = []
    for i, (text, frames) in enumerate((("first row text", 9), ("second", 6))):
        lat = rng.normal(size=(frames, 8)).astype(np.float32)
        items.append(collate.Item(
            input_ids=np.asarray(tokens.build_prompt_ids(tok, text), np.int32),
            audio_latents=lat, audio_distribution=lat.copy(), raw_text=text,
            speech_path=src if i == 0 else ""))
    return collate.collate(items, tok.pad_token_id), src


def _trainers(models, tmp_path):
    _, (jcfg, jp, _), (cfg, tp, _) = models
    exp = types.SimpleNamespace(exp_dir=str(tmp_path), project_name="p")
    jtr = types.SimpleNamespace(cfg=jcfg, exp=exp, state=types.SimpleNamespace(params=jp))
    tr = types.SimpleNamespace(cfg=cfg, exp=exp, main=True, device=torch.device("cpu"),
                               state=types.SimpleNamespace(params=tp, layout=None))
    return jtr, tr


def _run(models, tmp_path, np_batch):
    _, (_, _, jcodec), (_, _, codec) = models
    jtr, tr = _trainers(models, tmp_path)
    jeval_hook.make_eval_audio_hook(jcodec, str(tmp_path / "jax"))(jtr, STEP, np_batch)
    eval_hook.make_eval_audio_hook(codec, str(tmp_path / "port"))(tr, STEP, np_batch)
    return tmp_path / "jax", tmp_path / "port"


def test_gt_text_and_copy_match_jax(models, batch, tmp_path):
    np_batch, src = batch
    jdir, pdir = _run(models, tmp_path, np_batch)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        f"sample_{STEP}-{s}" for s in ("gen.txt", "gen.wav", "gt.wav", "gt2.wav")]
    got, sr = read_wav(str(pdir / f"sample_{STEP}-gt.wav"))
    ref, jsr = read_wav(str(jdir / f"sample_{STEP}-gt.wav"))
    hop = models[2][2].samples_per_frame
    assert sr == jsr == 24000 and got.shape == ref.shape == (1, 9 * hop)  # row 0's frames
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (pdir / f"sample_{STEP}-gen.txt").read_text() == "first row text"
    with open(src, "rb") as f:
        assert (pdir / f"sample_{STEP}-gt2.wav").read_bytes() == f.read()


def test_gen_matches_jax_with_the_noise_injected(models, batch, tmp_path, monkeypatch):
    np_batch, _ = batch
    noise = np.random.default_rng(5).standard_normal(
        np_batch["audio_latents"].shape).astype(np.float32)
    jforward, forward = jllasa.forward, llasa.forward
    monkeypatch.setattr(jllasa, "forward", lambda p, cfg, b, rng=None, **kw: jforward(
        p, cfg, b, latent_noise=jnp.asarray(noise)))
    monkeypatch.setattr(llasa, "forward", lambda p, cfg, b, generator=None, **kw: forward(
        p, cfg, b, latent_noise=torch.from_numpy(noise)))
    jdir, pdir = _run(models, tmp_path, np_batch)
    got, _ = read_wav(str(pdir / f"sample_{STEP}-gen.wav"))
    ref, _ = read_wav(str(jdir / f"sample_{STEP}-gen.wav"))
    hop = models[2][2].samples_per_frame
    assert got.shape == ref.shape == (1, 9 * hop) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_every_and_an_empty_row(models, batch, tmp_path):
    np_batch, _ = batch
    _, tr = _trainers(models, tmp_path)
    hook = eval_hook.make_eval_audio_hook(models[2][2], str(tmp_path / "out"), every=2)
    hook(tr, 1, np_batch)
    assert not (tmp_path / "out").exists()
    hook(tr, 2, np_batch)
    assert sorted(os.listdir(tmp_path / "out"))[0] == "sample_2-gen.txt"
    empty = dict(np_batch, audio_mask=np.zeros_like(np_batch["audio_mask"]))
    eval_hook.make_eval_audio_hook(models[2][2], str(tmp_path / "none"))(tr, 3, empty)
    assert os.listdir(tmp_path / "none") == []


def test_fit_calls_the_hook_on_log_steps(models, tmp_path):
    tok, _, (cfg, _, codec) = models
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        path = tmp_path / f"lat{i}.npy"
        np.save(path, rng.normal(size=(1, 6 + i, 8)).astype(np.float32))
        rows.append(f'{{"id": "u{i}", "caption": "text {i}", "vae": "{path}"}}')
    (tmp_path / "meta.jsonl").write_text("\n".join(rows))
    exp = config.ExperimentConfig(
        exp_dir=str(tmp_path / "exp"), model=cfg,
        train=config.TrainConfig(lr=1e-3, warmup_steps=1, log_interval=2, save_interval=100),
        data=config.DataConfig(meta_path=str(tmp_path / "meta.jsonl"), batch_size=2,
                               use_dynamic=False, num_workers=1, length_buckets=(32,),
                               max_length=32))
    calls = []
    hook = eval_hook.make_eval_audio_hook(codec)
    tr = Trainer(exp, tok, eval_hook=lambda *a: (calls.append(a[1]), hook(*a)), device="cpu")
    tr.fit(max_steps=4)
    assert calls == [2, 4]
    d = os.path.join(exp.exp_dir, exp.project_name, "eval_audios")
    for step in (2, 4):
        a, sr = read_wav(os.path.join(d, f"sample_{step}-gen.wav"))
        assert sr == 24000 and a.shape[0] == 1 and np.isfinite(a).all()
