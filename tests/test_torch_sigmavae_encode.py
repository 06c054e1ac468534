"""SigmaVAE encoder parity: the port's `encode` against the JAX `encode` in
f32 (atol 1e-5 / rtol 1e-5, as tests/test_torch_convnext.py) on the tiny
and the default widths, (B, T) and (B, 1, T) wavs, with T a multiple of
the default hop and not; the `gemm_blocks` formulation; the VibeVoice
state-dict export and import against the JAX package's; and `sample`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import sigmavae as jvae
from kalle_tpu_torch import bridge
from kalle_tpu_torch.models.codecs import sigmavae

TOL = dict(atol=1e-5, rtol=1e-5)
HOP = 3200  # the default config's


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(name):
    if name == "tiny":
        return jvae.SigmaVAEConfig.tiny(), sigmavae.SigmaVAEConfig.tiny()
    return jvae.SigmaVAEConfig(), sigmavae.SigmaVAEConfig()


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, name in enumerate(("tiny", "default")):
        jcfg, tcfg = _configs(name)
        jp = jvae.init_params(jcfg, jax.random.key(10 + i))
        out[name] = (jcfg, jp, tcfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                            device="cpu"))
    return out


def _wav(t, layout):
    w = (0.3 * np.random.default_rng(t).normal(size=(2, t))).astype(np.float32)
    return w[:, None, :] if layout == "b1t" else w


@pytest.mark.parametrize("name", ["tiny", "default"])
@pytest.mark.parametrize("layout", ["bt", "b1t"])
@pytest.mark.parametrize("t", [3 * HOP, 3 * HOP + 1234])
def test_encode_matches_jax(models, name, layout, t):
    jcfg, jp, tcfg, tp = models[name]
    wav = _wav(t, layout)
    ref = np.asarray(jvae.encode(jp, jcfg, jnp.asarray(wav)))
    got = sigmavae.encode(tp, tcfg, torch.tensor(wav))
    assert got.shape == (2, t // tcfg.hop, tcfg.latent_dim) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_gemm_blocks_match_jax(models, what):
    """The opt-in folded formulation computes what JAX's does, and what the
    depthwise blocks compute."""
    jcfg, jp, tcfg, tp = models["tiny"]
    jcfg = dataclasses.replace(jcfg, gemm_blocks=True)
    gcfg = dataclasses.replace(tcfg, gemm_blocks=True)
    if what == "encode":
        x = _wav(1000, "bt")
    else:
        x = np.random.default_rng(4).normal(size=(2, 5, tcfg.latent_dim)).astype(np.float32)
    ref = np.asarray(getattr(jvae, what)(jp, jcfg, jnp.asarray(x)))
    got = getattr(sigmavae, what)(tp, gcfg, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = getattr(sigmavae, what)(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_state_dict_matches_jax_and_round_trips(models, name):
    jcfg, jp, tcfg, tp = models[name]
    sd = sigmavae.state_dict_from_params(tp, tcfg)
    jsd = jvae.state_dict_from_params(jp, jcfg)
    assert list(sd) == list(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]), err_msg=k)
    # torch tensors under a wrapper prefix import back to the same tree
    wrapped = {f"acoustic_tokenizer.{k}": torch.from_numpy(v) for k, v in sd.items()}
    back = sigmavae.params_from_torch_state_dict(wrapped, tcfg, device="cpu")
    jback = jvae.params_from_torch_state_dict(jsd, jcfg)
    # (jax.tree.leaves walks every tree in sorted key order; torch tensors are leaves)
    leaves, jleaves, orig_leaves = (jax.tree.leaves(t) for t in (back, jback, tp))
    assert len(leaves) == len(jleaves) == len(orig_leaves)
    for got, ref, orig in zip(leaves, jleaves, orig_leaves):
        assert torch.equal(got, orig)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_modes():
    mean = torch.randn(3, 7, 8, generator=torch.Generator().manual_seed(0))

    def draw(mode, seed=1):
        return sigmavae.sample(torch.Generator().manual_seed(seed), mean, 0.5, mode)

    fix, gauss, same = draw("fix"), draw("gaussian"), draw("none")
    assert fix.shape == gauss.shape == same.shape == mean.shape
    assert same is mean
    assert torch.equal(fix, draw("fix")) and not torch.equal(fix, draw("fix", seed=2))
    # fix: mean + 0.5 * N(0, 1) from the generator's first draw
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(fix, mean + 0.5 * noise)
    # gaussian: one std per row, then the noise
    g = torch.Generator().manual_seed(1)
    std = torch.randn(3, generator=g) * (0.5 / 0.8)
    torch.testing.assert_close(gauss, mean + std[:, None, None] * torch.randn(mean.shape,
                                                                             generator=g))
