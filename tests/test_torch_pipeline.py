"""InferTools end to end against the JAX package's, on the tiny setup of
tests/test_infer_pipeline.py, with the noise removed on both sides:
`generate` runs greedy and `sigmavae.sample` returns the mean. Audio of
`synthesize` (with and without an audio prompt) and `synthesize_batch`
agrees within 1e-4; the wavs `infer_jsonl` writes agree within 2/32768
read back (they are peak-normalized to int16). Also the audio I/O helpers
against JAX's copies, and the two inference CLIs on the CPU."""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig, LlasaConfig as JLlasaConfig
from kalle_tpu.data.tokens import build_tokenizer as jbuild_tokenizer
from kalle_tpu.infer import pipeline as jpipeline
from kalle_tpu.infer.generate import generate as jgenerate
from kalle_tpu.models.codecs import sigmavae as jvae
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.utils import audio as jaudio
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.checkpoint import save_params_npz
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.data.tokens import build_tokenizer
from kalle_tpu_torch.infer import batch_cli, cli, pipeline
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.ops.quant import quantize_llama_params
from kalle_tpu_torch.utils import audio

AUDIO_TOL = 1e-4
WAV_TOL = 2 / 32768
MAX_FRAMES = 8
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


@pytest.fixture(scope="module")
def models():
    jtok = jbuild_tokenizer()
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(vocab_size=len(jtok)), latent_dim=8,
                        audio_proj_dim=64, head_variant="sigma")
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    jcodec = jpipeline.Codec.random_init("sigma", cfg=jvae.SigmaVAEConfig.tiny())
    tok = build_tokenizer()
    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=len(tok)), latent_dim=8,
                      audio_proj_dim=64, head_variant="sigma")
    host = lambda tree: bridge.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    codec = pipeline.Codec("sigma", sigmavae.SigmaVAEConfig.tiny(), host(jcodec.params))
    return (jtok, jcfg, jp, jcodec), (tok, cfg, host(jp), codec)


@pytest.fixture
def tools(models, tmp_path, monkeypatch):
    """Both InferTools, noise removed: greedy decode, sample = the mean."""
    monkeypatch.setattr(jpipeline, "generate", functools.partial(jgenerate, greedy=True))
    monkeypatch.setattr(pipeline, "generate", functools.partial(generate, greedy=True))
    monkeypatch.setattr(jvae, "sample", lambda rng, mean, sigma=0.5, dist_type="fix": mean)
    monkeypatch.setattr(sigmavae, "sample", lambda g, mean, sigma=0.5, dist_type="fix": mean)
    (jtok, jcfg, jp, jcodec), (tok, cfg, tp, codec) = models
    jit = jpipeline.InferTools(jcfg, jp, jtok, jcodec, output_root=str(tmp_path / "jax"),
                               timestamp=False)
    it = pipeline.InferTools(cfg, tp, tok, codec, output_root=str(tmp_path / "torch"),
                             timestamp=False)
    return jit, it


@pytest.mark.parametrize("prompt", [False, True], ids=["text", "voice_prompt"])
def test_synthesize_matches_jax(tools, prompt):
    jit, it = tools
    lat = (np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
           if prompt else None)
    ref = np.asarray(jit.synthesize("a test sound", max_frames=MAX_FRAMES, prompt_latents=lat))
    got = it.synthesize("a test sound", max_frames=MAX_FRAMES, prompt_latents=lat)
    assert got.shape == ref.shape == (1, (MAX_FRAMES - 1) * it.codec.samples_per_frame)
    np.testing.assert_allclose(got, ref, atol=AUDIO_TOL, rtol=0)


def test_synthesize_batch_matches_jax(tools):
    """Mixed prompt lengths over two buckets (16, 32) and a short last
    group padded by repeating its last row."""
    jit, it = tools
    texts = ["hi", "a slightly longer caption here", "x", "medium one ok",
             "tiny", "another short", "yet another short text"]
    kw = dict(max_frames=MAX_FRAMES, batch_size=4, prompt_buckets=(16, 32))
    ref = jit.synthesize_batch(texts, **kw)
    got = it.synthesize_batch(texts, **kw)
    assert len(got) == len(texts)
    for g, r in zip(got, ref):
        assert g.shape == np.asarray(r).shape == (1, (MAX_FRAMES - 1) * it.codec.samples_per_frame)
        np.testing.assert_allclose(g, np.asarray(r), atol=AUDIO_TOL, rtol=0)


def _write_rows(root, n_with_latents=2):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        row = {"id": f"utt{i}", "caption": f"a test sound {i}"}
        if i < n_with_latents:
            p = os.path.join(root, f"lat{i}.npy")
            np.save(p, rng.normal(size=(1, 6 + i, 8)).astype(np.float32))
            row["vae"] = p
        rows.append(row)
    rows[2] = {"id": "utt2", "text": "from the text key", "caption": ""}
    meta = os.path.join(root, "meta.jsonl")
    with open(meta, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))
    return meta


def test_infer_jsonl_matches_jax(tools, tmp_path):
    jit, it = tools
    meta = _write_rows(str(tmp_path))
    ref = jit.infer_jsonl(meta, max_frames=MAX_FRAMES)
    got = it.infer_jsonl(meta, max_frames=MAX_FRAMES)
    names = ["utt0---copysyn.wav", "utt0---gen.wav", "utt1---copysyn.wav",
             "utt1---gen.wav", "utt2---gen.wav"]
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == names
    assert it.output_dir.endswith("kalle_tpu-ckpt")
    for utt, text in (("utt0", "a test sound 0"), ("utt2", "from the text key")):
        with open(os.path.join(it.output_dir, f"{utt}.txt")) as f:
            assert f.read() == text
    hop = it.codec.samples_per_frame
    for g, r in zip(got, ref):
        wg, sr = audio.read_wav(g)
        wr, _ = jaudio.read_wav(r)
        assert sr == 24000 and wg.shape == wr.shape
        np.testing.assert_allclose(wg, wr, atol=WAV_TOL, rtol=0, err_msg=g)
    assert audio.read_wav(got[0])[0].shape == (1, 6 * hop)  # copysyn: T_i frames
    assert audio.read_wav(got[1])[0].shape == (1, 7 * hop)  # gen: max_frames - 1
    assert it.infer_jsonl(meta, max_frames=MAX_FRAMES, limit=1, copysyn=False) == [
        os.path.join(it.output_dir, "utt0---gen.wav")]


def test_audio_io_matches_jax(tmp_path):
    x = (0.5 * np.random.default_rng(0).normal(size=(2, 500))).astype(np.float32)
    np.testing.assert_array_equal(audio.normalize_int16(x), jaudio.normalize_int16(x))
    for mod, name in ((audio, "torch.wav"), (jaudio, "jax.wav")):
        mod.write_wav(str(tmp_path / name), x, 16000)
    assert (tmp_path / "torch.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    y, sr = audio.read_wav(str(tmp_path / "torch.wav"))
    jy, jsr = jaudio.read_wav(str(tmp_path / "jax.wav"))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(y, jy)
    for sr_out in (16000, 24000, 11025):
        np.testing.assert_array_equal(audio.resample_linear(x, 16000, sr_out),
                                      jaudio.resample_linear(x, 16000, sr_out))


@pytest.fixture
def tiny_yaml(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def test_infer_cli_on_cpu(tiny_yaml, tmp_path, capsys):
    meta = _write_rows(str(tmp_path), n_with_latents=1)
    out = str(tmp_path / "out")
    cli.main(["-c", tiny_yaml, "-i", meta, "-o", out, "-m", "4", "--limit", "2",
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    run_dir = os.path.join(out, os.listdir(out)[0])
    assert os.path.basename(run_dir).startswith("tiny-random-")
    assert f"wrote 3 files to {run_dir}" in lines
    assert sorted(os.listdir(run_dir)) == ["utt0---copysyn.wav", "utt0---gen.wav", "utt0.txt",
                                           "utt1---gen.wav", "utt1.txt"]
    gen, sr = audio.read_wav(os.path.join(run_dir, "utt1---gen.wav"))
    assert sr == 24000 and gen.shape == (1, 3 * 3200) and np.isfinite(gen).all()
    # an int8 .npz checkpoint loads (the name goes into the run directory)
    ckpt = str(tmp_path / "params.npz")
    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=265), latent_dim=8, audio_proj_dim=64)
    from kalle_tpu_torch.models.lm import llasa

    save_params_npz(ckpt, quantize_llama_params(
        llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    cli.main(["-c", tiny_yaml, "-i", meta, "-o", out, "-p", ckpt, "-m", "4", "--limit", "1",
              "--device", "cpu"])
    assert any(d.startswith("tiny-params.npz-") for d in os.listdir(out))


def test_reference_checkpoint_raises(tiny_yaml, tmp_path):
    meta = _write_rows(str(tmp_path))
    # a reference .pt is read now (tests/test_torch_convert.py); a missing one raises
    with pytest.raises(FileNotFoundError):
        cli.main(["-c", tiny_yaml, "-i", meta, "-p", str(tmp_path / "llasa.pt"),
                  "--device", "cpu"])
    # the stableaudio and melvae loaders exist (tests/test_torch_oobleck.py,
    # test_torch_melvae.py): missing files raise
    for kind in ("stableaudio", "melvae"):
        with pytest.raises(FileNotFoundError):
            pipeline.Codec.load(kind, str(tmp_path / "cfg.json"), str(tmp_path / "codec.ckpt"),
                                device="cpu")
    with pytest.raises(ValueError, match="no pretrained loader"):
        pipeline.Codec.load("sigma", "cfg.json", "codec.ckpt")


@pytest.mark.parametrize("chat", [False, True], ids=["raw", "chat_template"])
def test_batch_cli_on_cpu(tiny_yaml, capsys, chat):
    batch_cli.main(["--config", tiny_yaml, "--repeats", "2", "--steps", "4", "--device", "cpu"]
                   + (["--chat-template"] if chat else []))
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 4 and all(len(ln.split()[3:]) == 2 for ln in steps)
    kl = np.array([[float(v) for v in ln.split()[3:]] for ln in steps])
    assert np.isfinite(kl).all() and (kl > 0).all()  # the detector is off, not the trace
    assert lines[-1] == "n_frames: [3, 3]"
