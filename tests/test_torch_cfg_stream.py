"""The port's classifier-free-guidance and streaming generation against the
JAX package's on the CPU, with JAX's draws rebuilt from the same key
splits and injected: `cfg_generate` v1 and v2 (the MLP head of
`llasa.init_params` and the variants' Linear head, a run to max_frames and
one that stops early) and `stream_generate` (with warm-up latents and a
speaker frame), in f32 within 1e-4 of max |ref| and in bf16 within 2e-2;
`sample_speaker_cond` with and without a speaker embedding;
`warmup_latents_from_silence`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig, LlasaConfig as JLlasaConfig
from kalle_tpu.infer import cfg as jcfgmod
from kalle_tpu.infer import streaming as jstream
from kalle_tpu.models.conditioning import ecapa as jecapa
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.models.lm import variants as jvar
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.infer import cfg as cfgmod
from kalle_tpu_torch.infer import streaming

D, H, FRAMES = 8, 64, 7
ECAPA = dict(in_channels=8, channels=16, embd_dim=H, scale=4, attn_bottleneck=8,
             pooled_channels=24)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    jl = dataclasses.replace(JLlamaConfig.tiny(), dtype=dtype)
    tl = dataclasses.replace(LlamaConfig.tiny(), dtype=dtype)
    return (JLlasaConfig(llama=jl, latent_dim=D, audio_proj_dim=H, head_variant="melvae"),
            LlasaConfig(llama=tl, latent_dim=D, audio_proj_dim=H, head_variant="melvae"))


@pytest.fixture(scope="module")
def heads():
    """{"mlp": llasa params, "linear": the variants' params}, JAX and torch."""
    jc, _ = _cfgs("float32")
    mlp = jllasa.init_params(jc, jax.random.key(0))
    lin = jvar.init_variant_params(jc, jax.random.key(1), jecapa.EcapaConfig(**ECAPA),
                                   speaker_vae=True)
    host = lambda p: bridge.params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    return {"mlp": (mlp, host(mlp)), "linear": (lin, host(lin))}


def _cast(jp, tp, dtype):
    if dtype == "float32":
        return jp, tp
    return (jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp),
            bridge.tree_map(lambda t: t.to(torch.bfloat16), tp))


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, np.abs(ref).max()), rtol=0)


def _step_noise(rng, b, steps, dtype):
    """JAX's per-step draws: rng, krng = split(rng); normal(krng, (b, 1, d))."""
    out = []
    for _ in range(steps):
        rng, krng = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(krng, (b, 1, D), jnp.dtype(dtype)), np.float32))
    return torch.from_numpy(np.concatenate(out, axis=1))


@pytest.mark.parametrize("head,variant,dtype,thres", [
    ("mlp", "v1", "float32", 0.0), ("mlp", "v2", "float32", 0.0),
    ("linear", "v1", "float32", 50.0), ("linear", "v2", "float32", 0.0),
    ("mlp", "v1", "bfloat16", 0.0), ("mlp", "v2", "bfloat16", 0.0)])
def test_cfg_generate_matches_jax(heads, head, variant, dtype, thres):
    jc, tc = _cfgs(dtype)
    jp, tp = _cast(*heads[head], dtype)
    ids = np.random.default_rng(0).integers(0, 300, (1, 6)).astype(np.int32)
    key = jax.random.key(5)
    ref = jcfgmod.cfg_generate(jp, jc, jnp.asarray(ids), key, FRAMES, cfg_variant=variant,
                               guidance_k=0.3, end_kl_threshold=thres)
    noise = _step_noise(jax.random.split(key)[0], 1, FRAMES, dtype)
    got = cfgmod.cfg_generate(tp, tc, torch.from_numpy(ids).long(), max_frames=FRAMES,
                              cfg_variant=variant, guidance_k=0.3, end_kl_threshold=thres,
                              noise=noise)
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    want = FRAMES - 1 if thres == 0.0 else jc.min_frames
    assert int(got.n_frames[0]) == want
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, TOL[dtype])


def test_cfg_variants_differ_and_draw(heads):
    """v1 and v2 guide differently; the generator's own draws are finite."""
    _, tc = _cfgs("float32")
    tp = heads["mlp"][1]
    ids = torch.randint(0, 300, (1, 6), generator=torch.Generator().manual_seed(0))
    noise = torch.zeros(1, FRAMES, D)
    v1 = cfgmod.cfg_generate(tp, tc, ids, max_frames=FRAMES, noise=noise, end_kl_threshold=0.0)
    v2 = cfgmod.cfg_generate(tp, tc, ids, max_frames=FRAMES, cfg_variant="v2", noise=noise,
                             end_kl_threshold=0.0)
    assert float((v1.samples - v2.samples).abs().max()) > 1e-4
    drawn = cfgmod.cfg_generate(tp, tc, ids, torch.Generator().manual_seed(1),
                                max_frames=FRAMES, end_kl_threshold=0.0)
    assert torch.isfinite(drawn.samples).all()
    with pytest.raises(ValueError):
        cfgmod.cfg_generate(tp, tc, ids, max_frames=2, cfg_variant="v3")


@pytest.mark.parametrize("dtype,thres", [("float32", 0.0), ("float32", 50.0),
                                         ("bfloat16", 0.0)])
def test_stream_generate_matches_jax(heads, dtype, thres):
    jc, tc = _cfgs(dtype)
    jp, tp = _cast(*heads["linear"], dtype)
    rng = np.random.default_rng(1)
    b, t_text, t_warm, steps = 2, 9, 2, FRAMES
    ids = rng.integers(0, 300, (b, t_text)).astype(np.int32)
    warm = rng.normal(size=(b, t_warm, D)).astype(np.float32)
    spk = rng.normal(size=(b, H)).astype(np.float32)
    key = jax.random.key(7)
    ref = jstream.stream_generate(jp, jc, jnp.asarray(ids), jnp.asarray(warm), jnp.asarray(spk),
                                  key, steps, end_kl_threshold=thres)
    got = streaming.stream_generate(tp, tc, torch.from_numpy(ids).long(), torch.from_numpy(warm),
                                    torch.from_numpy(spk), max_steps=steps,
                                    end_kl_threshold=thres,
                                    noise=_step_noise(key, b, steps, dtype))
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, TOL[dtype])


def test_sample_speaker_cond(heads):
    jp, tp = heads["linear"]
    key = jax.random.key(2)
    emb = np.random.default_rng(3).normal(size=(3, H)).astype(np.float32)
    ref = jstream.sample_speaker_cond(jp, key, H, jnp.asarray(emb))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (3, H))))
    got = streaming.sample_speaker_cond(tp, None, H, torch.from_numpy(emb), noise=noise)
    _close(got, ref, 1e-5)
    ref0 = jstream.sample_speaker_cond(jp, key, H)
    got0 = streaming.sample_speaker_cond(tp, None, H, noise=torch.from_numpy(
        np.array(jax.random.normal(key, (1, H)))), device="cpu")
    _close(got0, ref0, 1e-6)
    drawn = streaming.sample_speaker_cond(tp, torch.Generator().manual_seed(0), H,
                                          torch.from_numpy(emb))
    assert tuple(drawn.shape) == (3, H) and torch.isfinite(drawn).all()


def test_warmup_latents_from_silence():
    seen = []

    def encode(wav):
        seen.append(tuple(wav.shape))
        return wav.sum()

    out = streaming.warmup_latents_from_silence(encode, 2, 16000, 12.5, batch=3, device="cpu")
    assert seen == [(3, 1, 2560)] and float(out) == 0.0
    ref = []
    jstream.warmup_latents_from_silence(lambda w: ref.append(w.shape), 2, 16000, 12.5, batch=3)
    assert ref == seen
