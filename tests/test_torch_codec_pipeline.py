"""InferTools with the stableaudio (Oobleck) and melvae (flow_reverse)
codecs against the JAX package's, on a tiny Llasa with `generate` greedy
on both sides: `synthesize_batch` audio within 1e-4 of max |ref|, the wavs
`infer_jsonl` writes (copysyn from a mean||scale .npy, gen) within
2/32768 read back. Also `OnlineEncoder.encode_batch` (sigma, stableaudio
with fake stereo, melvae) and `StreamingCollator` against JAX's with the
same numpy seed, `OnlineAudioDataset.make_items` on WAV bytes, and the
inference CLI with a melvae codec on the CPU."""
import functools
import io
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig, LlasaConfig as JLlasaConfig
from kalle_tpu.data import online as jonline
from kalle_tpu.data import streaming as jstreaming
from kalle_tpu.data.tokens import build_tokenizer as jbuild_tokenizer
from kalle_tpu.infer import pipeline as jpipeline
from kalle_tpu.infer.generate import generate as jgenerate
from kalle_tpu.models.codecs import melvae as jmel
from kalle_tpu.models.codecs import oobleck as joob
from kalle_tpu.models.codecs import sigmavae as jsig
from kalle_tpu.utils import audio as jaudio
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.data import online, streaming
from kalle_tpu_torch.data.tokens import build_tokenizer
from kalle_tpu_torch.infer import cli, pipeline
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.models.codecs import melvae, oobleck, sigmavae
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.utils import audio

TOL, WAV_TOL, MAX_FRAMES, D = 1e-4, 2 / 32768, 6, 8
OOB = dict(channels=4, latent_dim=D, encoder_out_dim=2 * D, c_mults=(1, 2), strides=(2, 4))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(tree):
    """A port param tree -> (the same values as JAX arrays, as torch on the
    CPU): the port's init stands in for JAX's, which is slow eagerly."""
    host = bridge.params_to_numpy(tree)
    return jax.tree.map(jnp.asarray, host), bridge.params_from_jax(host, device="cpu")


def _flow_perturbed(tp):
    """Nonzero flow posts (a fresh init makes the flow the identity)."""
    g = torch.Generator().manual_seed(0)
    for f in tp["flows"]:
        f["post"] = {k: 0.3 * torch.randn(v.shape, generator=g) for k, v in f["post"].items()}
    return tp


@pytest.fixture(scope="module")
def codecs():
    """{kind: (JAX Codec, port Codec)} over the same params."""
    out = {}
    for kind, mod, cfg, jcfg in (
            ("stableaudio", oobleck, oobleck.OobleckConfig(**OOB), joob.OobleckConfig(**OOB)),
            ("melvae", melvae, melvae.MelVAEConfig.tiny(), jmel.MelVAEConfig.tiny()),
            ("sigma", sigmavae, sigmavae.SigmaVAEConfig.tiny(), jsig.SigmaVAEConfig.tiny())):
        tree = mod.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        jp, tp = _both(_flow_perturbed(tree) if kind == "melvae" else tree)
        out[kind] = (jpipeline.Codec(kind, jcfg, jp), pipeline.Codec(kind, cfg, tp))
    return out


@pytest.fixture(scope="module")
def lms():
    jtok, tok = jbuild_tokenizer(), build_tokenizer()
    out = {}
    for kind in ("stableaudio", "melvae"):
        jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(vocab_size=len(jtok)), latent_dim=D,
                            audio_proj_dim=64, head_variant=kind)
        cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=len(tok)), latent_dim=D,
                          audio_proj_dim=64, head_variant=kind)
        jp, tp = _both(llasa.init_params(cfg, torch.Generator().manual_seed(2), "cpu"))
        out[kind] = (jtok, jcfg, jp), (tok, cfg, tp)
    return out


def _tools(kind, codecs, lms, root, monkeypatch):
    monkeypatch.setattr(jpipeline, "generate", functools.partial(jgenerate, greedy=True))
    monkeypatch.setattr(pipeline, "generate", functools.partial(generate, greedy=True))
    (jtok, jcfg, jp), (tok, cfg, tp) = lms[kind]
    jc, tc = codecs[kind]
    fr = kind == "melvae"
    jit = jpipeline.InferTools(jcfg, jp, jtok, jc, output_root=os.path.join(root, "jax"),
                               timestamp=False, flow_reverse=fr)
    it = pipeline.InferTools(cfg, tp, tok, tc, output_root=os.path.join(root, "torch"),
                             timestamp=False, flow_reverse=fr)
    return jit, it


@pytest.mark.parametrize("kind", ["stableaudio", "melvae"])
def test_synthesize_batch_matches_jax(codecs, lms, tmp_path, monkeypatch, kind):
    jit, it = _tools(kind, codecs, lms, str(tmp_path), monkeypatch)
    texts = ["hi", "a slightly longer caption here", "x"]
    kw = dict(max_frames=MAX_FRAMES, batch_size=2, prompt_buckets=(16, 32))
    ref, got = jit.synthesize_batch(texts, **kw), it.synthesize_batch(texts, **kw)
    channels = 2 if kind == "stableaudio" else 1
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape == (channels, (MAX_FRAMES - 1) * it.codec.samples_per_frame)
        np.testing.assert_allclose(g, r, atol=TOL * max(1.0, np.abs(r).max()), rtol=0)
    one = it.synthesize("hi", max_frames=MAX_FRAMES)
    np.testing.assert_allclose(one, np.asarray(jit.synthesize("hi", max_frames=MAX_FRAMES)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["stableaudio", "melvae"])
def test_infer_jsonl_matches_jax(codecs, lms, tmp_path, monkeypatch, kind):
    jit, it = _tools(kind, codecs, lms, str(tmp_path), monkeypatch)
    rng = np.random.default_rng(2)
    rows = []
    for i in range(2):
        p = str(tmp_path / f"lat{i}.npy")
        lat = np.concatenate([rng.normal(size=(1, D, 4 + i)),
                              np.abs(rng.normal(size=(1, D, 4 + i))) * 0.3], axis=1)
        np.save(p, lat.astype(np.float32))
        rows.append({"id": f"u{i}", "caption": f"a test sound {i}", "vae": p})
    ref = jit.infer_jsonl(rows, max_frames=MAX_FRAMES)
    got = it.infer_jsonl(rows, max_frames=MAX_FRAMES)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == [
        "u0---copysyn.wav", "u0---gen.wav", "u1---copysyn.wav", "u1---gen.wav"]
    spf = it.codec.samples_per_frame
    for g, r, n in zip(got, ref, (4, MAX_FRAMES - 1, 5, MAX_FRAMES - 1)):
        wg, sr = audio.read_wav(g)
        wr, _ = jaudio.read_wav(r)
        assert sr == it.codec.sample_rate and wg.shape == wr.shape
        assert wg.shape[-1] == n * spf
        np.testing.assert_allclose(wg, wr, atol=WAV_TOL, rtol=0, err_msg=g)


@pytest.mark.parametrize("kind", ["sigma", "stableaudio", "melvae"])
def test_online_encoder_matches_jax(codecs, kind):
    jc, tc = codecs[kind]
    rng = np.random.default_rng(3)
    wavs = [(0.3 * rng.normal(size=(1, n))).astype(np.float32) for n in (37, 64, 20)]
    ref = jonline.OnlineEncoder(jc).encode_batch(wavs)
    enc = online.OnlineEncoder(tc)
    assert enc.fake_stereo == (kind == "stableaudio")
    got = enc.encode_batch(wavs)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=TOL * max(1.0, np.abs(r).max()), rtol=0)


def test_streaming_collator_matches_jax(codecs):
    jc, tc = codecs["melvae"]
    rng = np.random.default_rng(4)
    batch = [{"input_ids": rng.integers(0, 256, n).astype(np.int32),
              "wav": (0.3 * rng.normal(size=(1, m))).astype(np.float32),
              "mel_wav": (0.3 * rng.normal(size=(1, 3200 + m))).astype(np.float32)}
             for n, m in ((5, 200), (9, 176))]
    kw = dict(delay_frames=2, frame_hz=16000 / jc.cfg.hop, spk_drop_prob=0.5, seed=5)
    ref = jstreaming.StreamingCollator(jonline.OnlineEncoder(jc), jbuild_tokenizer(), **kw)(batch)
    got = streaming.StreamingCollator(online.OnlineEncoder(tc), build_tokenizer(), **kw)(batch)
    assert set(got) == set(ref)
    for k in ("input_ids", "speaker_cond_keep", "attention_mask", "target_mask", "end_mask"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for k in ("audio_latents", "distribute_labels", "mels"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k], r, atol=TOL * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=k)
    assert got["mels"].shape == (2, 80, 200)
    short = [{"input_ids": np.zeros(40, np.int32), "wav": batch[0]["wav"],
              "mel_wav": batch[0]["mel_wav"]}]
    assert streaming.StreamingCollator(online.OnlineEncoder(tc), build_tokenizer(), **kw)(
        short) is None


def _wav_bytes(x, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(x.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((x.T * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["sigma", "melvae"])
def test_online_dataset_matches_jax(codecs, kind):
    jc, tc = codecs[kind]
    rng = np.random.default_rng(6)
    rows = [{"id": f"r{i}", "text_normalized": f"row {i}",
             "audio": {"bytes": _wav_bytes(0.5 * rng.uniform(-1, 1, (2, 300 + 50 * i)),
                                           22050)}} for i in range(2)]
    ref = jonline.OnlineAudioDataset(rows, jbuild_tokenizer(), jonline.OnlineEncoder(jc),
                                     seed=7).make_items([1, 0])
    got = online.OnlineAudioDataset(rows, build_tokenizer(), online.OnlineEncoder(tc),
                                    seed=7).make_items([1, 0])
    for g, r in zip(got, ref):
        assert (g.raw_text, g.speech_path) == (r.raw_text, r.speech_path)
        np.testing.assert_array_equal(g.input_ids, r.input_ids)
        for a, b in ((g.audio_latents, r.audio_latents),
                     (g.audio_distribution, r.audio_distribution)):
            np.testing.assert_allclose(a, b, atol=TOL * max(1.0, np.abs(b).max()), rtol=0)
    peak = online.normalize_peak(np.array([[0.5, -2.0]], np.float32))
    np.testing.assert_array_equal(peak, jonline.normalize_peak(np.array([[0.5, -2.0]],
                                                                       np.float32)))


def test_infer_cli_melvae_on_cpu(tmp_path, capsys):
    (tmp_path / "tiny.yaml").write_text(
        "project_name: tiny\nmodel:\n  latent_dim: 8\n  audio_proj_dim: 64\n"
        "  head_variant: melvae\n  llama: {vocab_size: 265, hidden_size: 64, "
        "intermediate_size: 128, num_layers: 2, num_heads: 4, num_kv_heads: 2, head_dim: 16, "
        "max_seq_len: 128, dtype: float32}\n")
    meta = tmp_path / "meta.jsonl"
    meta.write_text(json.dumps({"id": "t0", "caption": "tiny row"}))
    out = str(tmp_path / "out")
    cli.main(["-c", str(tmp_path / "tiny.yaml"), "-i", str(meta), "-o", out, "-m", "3",
              "--codec-kind", "melvae", "--device", "cpu"])
    run_dir = os.path.join(out, os.listdir(out)[0])
    assert f"wrote 1 files to {run_dir}" in capsys.readouterr().out.splitlines()
    gen, sr = audio.read_wav(os.path.join(run_dir, "t0---gen.wav"))
    # the random melvae head may stop at once: 1 or 2 frames kept of -m 3
    assert sr == 16000 and gen.shape in ((1, 1280), (1, 2 * 1280)) and np.isfinite(gen).all()
