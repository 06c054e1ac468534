"""The port's Llasa capability variants against the JAX package's, f32 on
the CPU at a tiny width, within 1e-4: the four training forwards (speaker
frame, with speaker dropout, text stream, stream + speaker VAE with JAX's
draw injected, framewise) — losses, means and log scales — and a gradient
through one of them; `cfg_attention_masks`; the weighted-difference
sampler with JAX's draw injected; the truncated normal by its bounds and
moments (JAX's draws cannot be reproduced) and at injected uniforms."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig, LlasaConfig as JLlasaConfig
from kalle_tpu.models.conditioning import ecapa as jecapa
from kalle_tpu.models.lm import variants as jvar
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.models.conditioning import ecapa
from kalle_tpu_torch.models.lm import variants

TOL = 1e-4
ECAPA = dict(in_channels=8, channels=16, embd_dim=64, scale=4, attn_bottleneck=8,
             pooled_channels=24)
B, T, D, H = 2, 9, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(), latent_dim=D, audio_proj_dim=H,
                        head_variant="melvae")
    cfg = LlasaConfig(llama=LlamaConfig.tiny(), latent_dim=D, audio_proj_dim=H,
                      head_variant="melvae")
    jp = jvar.init_variant_params(jcfg, jax.random.key(0), jecapa.EcapaConfig(**ECAPA),
                                  speaker_vae=True)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp, jecapa.EcapaConfig(**ECAPA)), (cfg, tp, ecapa.EcapaConfig(**ECAPA))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids_mask = np.zeros((B, T), np.int32)
    ids_mask[:, :4] = 1
    ids_mask[1, 3] = 0
    audio_mask = np.zeros((B, T), np.int32)
    audio_mask[0, 4:] = 1
    audio_mask[1, 4:7] = 1
    target = audio_mask.astype(bool)
    end = np.zeros((B, T), bool)
    end[0, -1] = end[1, 6] = True
    attn = np.ones((B, T), np.int32)
    attn[1, -2:] = 0
    bos_mask = np.zeros((B, T), bool)
    bos_mask[:, 0] = True
    return {
        "input_ids": rng.integers(0, 300, (B, T)).astype(np.int32),
        "audio_latents": rng.normal(size=(B, T, D)).astype(np.float32),
        "distribute_labels": np.concatenate(
            [rng.normal(size=(B, T, D)), 0.3 * rng.normal(size=(B, T, D)) - 0.5],
            axis=-1).astype(np.float32),
        "ids_mask": ids_mask, "audio_mask": audio_mask, "target_mask": target,
        "end_mask": end, "attention_mask": attn,
        "mels": rng.normal(size=(B, 8, 30)).astype(np.float32),
        "speaker_cond_keep": np.array([True, False]),
        "bos_token": np.full((B, 1), 7, np.int32), "bos_mask": bos_mask,
    }


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, np.abs(ref).max()), rtol=0)


def _check(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k, r in ref.items():
        if r is None:
            assert got[k] is None, k
        else:
            _close(got[k], r)


@pytest.mark.parametrize("kind", ["speaker", "speaker_dropout", "text_stream", "framewise"])
def test_forwards_match_jax(models, batch, kind):
    (jcfg, jp, jec), (cfg, tp, ec) = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if kind.startswith("speaker"):
        drop = kind == "speaker_dropout"
        ref = jvar.speaker_forward(jp, jcfg, jb, jec, speaker_dropout=drop)
        got = variants.speaker_forward(tp, cfg, tb, ec, speaker_dropout=drop)
    elif kind == "text_stream":
        ref = jvar.text_stream_forward(jp, jcfg, jb, jec)
        got = variants.text_stream_forward(tp, cfg, tb, ec)
    else:
        ref = jvar.framewise_speaker_forward(jp, jcfg, jb, jec)
        got = variants.framewise_speaker_forward(tp, cfg, tb, ec)
    _check(got, ref)


def test_speaker_dropout_takes_ones(models, batch, monkeypatch):
    """Row 1 (keep False) sees an embedding of ones: the same result as a
    speaker encoder whose output is ones."""
    (_, _, _), (cfg, tp, ec) = models
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = variants.speaker_forward(tp, cfg, tb, ec, speaker_dropout=True)
    monkeypatch.setattr(variants, "speaker_embedding", lambda p, c, m: torch.ones(m.shape[0], H))
    ones = variants.speaker_forward(tp, cfg, tb, ec)
    torch.testing.assert_close(got["pre_mean"][1], ones["pre_mean"][1], atol=1e-6, rtol=0)
    assert float((got["pre_mean"][0] - ones["pre_mean"][0]).abs().max()) > 1e-4


def test_stream_spkvae_matches_jax(models, batch):
    (jcfg, jp, jec), (cfg, tp, ec) = models
    key = jax.random.key(11)
    ref = jvar.stream_spkvae_forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jec, key)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], (B, H))))
    tpg = bridge.tree_map(lambda t: t.clone().requires_grad_(t.is_floating_point()), tp)
    got = variants.stream_spkvae_forward(tpg, cfg, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()},
                                         ec, spk_noise=noise)
    _check(got, ref)
    (got["audio_loss"] + got["speaker_cond_kl"]).backward()
    for name in ("audio_linear", "distribution_linear", "speaker_cond_disp_linear"):
        assert float(tpg[name]["w"].grad.abs().max()) > 0
    assert float(tpg["llama"]["layers"]["wq"].grad.abs().max()) > 0
    drawn = variants.stream_spkvae_forward(tp, cfg, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()},
                                           ec, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["audio_loss"])
    torch.testing.assert_close(drawn["speaker_cond_kl"], got["speaker_cond_kl"])


def test_init_variant_params_tree(models):
    (_, jp, _), (cfg, _, ec) = models
    tp = variants.init_variant_params(cfg, torch.Generator().manual_seed(0), ec,
                                      speaker_vae=True, device="cpu")
    shapes = lambda tree: sorted((tuple(x.shape) for x in bridge.tree_leaves(tree)))
    assert shapes(tp) == shapes(bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    assert "speaker_cond_disp_linear" not in variants.init_variant_params(
        cfg, torch.Generator().manual_seed(0), ec, device="cpu")


@pytest.mark.parametrize("variant,audio_len", [("v1", 5), ("v2", 6), ("v1", 0), ("v2", 0)])
def test_cfg_attention_masks(variant, audio_len):
    key = jax.random.key(3)
    ref, rappend = jvar.cfg_attention_masks(7, audio_len, variant, key, cfg_prob=0.5)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (1, audio_len)))) if audio_len else None
    got, append = variants.cfg_attention_masks(7, audio_len, variant, uniform=u, device="cpu")
    assert append == rappend
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        variants.cfg_attention_masks(7, 0, "v3", device="cpu")


def test_weighted_difference_sampling():
    rng = np.random.default_rng(5)
    m, s, cm, cs = (rng.normal(size=(2, 1, 8)).astype(np.float32) for _ in range(4))
    s, cs = np.abs(s), np.abs(cs)
    key = jax.random.key(9)
    ref = jvar.batch_weighted_difference_sampling(key, *map(jnp.asarray, (m, s, cm, cs)), K=0.3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, m.shape)))
    got = variants.batch_weighted_difference_sampling(None, *map(torch.from_numpy, (m, s, cm, cs)),
                                                      K=0.3, noise=noise)
    _close(got, ref, 1e-6)


def test_confidence_interval_sampling():
    conf = 0.9
    z = 1.6448536269514722  # the 95th percentile of N(0, 1)
    mean = torch.tensor([0.0, 1.0, -2.0, 3.0])
    std = torch.tensor([1.0, 0.5, 2.0, 0.1])
    x = variants.sample_within_confidence_interval(torch.Generator().manual_seed(0), mean, std,
                                                   conf, n_samples=40000)
    assert tuple(x.shape) == (40000, 4)
    u = (x - mean) / std
    assert float(u.abs().max()) <= z + 1e-5
    # the truncated normal's moments: mean 0, variance 1 - 2 z phi(z) / conf
    var = 1 - 2 * z * math.exp(-z * z / 2) / math.sqrt(2 * math.pi) / conf
    assert float(u.mean(0).abs().max()) < 0.02
    np.testing.assert_allclose(u.var(0).numpy(), var, rtol=0.03)
    # JAX's draws meet the same bounds
    jx = np.asarray(jvar.sample_within_confidence_interval(jax.random.key(0), jnp.zeros(4),
                                                           jnp.ones(4), conf, 2000))
    assert np.abs(jx).max() <= z + 1e-5
    # injected uniforms: 0.5 is the mean, 0 and 1 the interval's ends
    inj = variants.sample_within_confidence_interval(
        None, mean, std, conf, uniform=torch.tensor([[0.5, 0.0, 1.0, 0.5]], dtype=torch.float64))
    torch.testing.assert_close(inj[0], torch.stack([mean[0], mean[1] - z * std[1],
                                                    mean[2] + z * std[2], mean[3]]))
