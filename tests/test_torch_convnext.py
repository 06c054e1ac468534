"""K4 and SigmaVAE parity: the plain version of the port's ConvNeXt block
against the JAX Pallas kernel `fused_convnext_block` in interpret mode —
across time tiles, so the causal carry is exercised — and the port's
SigmaVAE decode against the JAX decode in f32 (atol 1e-5, as
tests/test_fused_block.py:24,45)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import sigmavae as jvae
from kalle_tpu.ops.pallas.convnext_block import fused_convnext_block
from kalle_tpu_torch import bridge
from kalle_tpu_torch.infer.pipeline import Codec
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.ops.kernels.convnext_block import convnext_block

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _block_params(channels, key):
    cfg = jvae.SigmaVAEConfig(latent_dim=8, strides=(2, 4), channels=channels,
                              blocks_per_stage=1)
    p = jvae.init_params(cfg, jax.random.key(key))
    return cfg, p["decoder"]["stages"][0]["blocks"][0]


def _args(blk):
    return (blk["norm"], blk["dw"]["w"], blk["dw"]["b"], blk["up"]["w"],
            blk["up"]["b"], blk["down"]["w"], blk["down"]["b"])


@pytest.mark.parametrize("channels,t,block_t", [
    ((16, 32), 64, 16),   # C=32, four time tiles: the causal carry
    ((32, 64), 96, 32),   # mid-width decoder block, C=64
])
def test_block_matches_jax_kernel(channels, t, block_t):
    cfg, blk = _block_params(channels, key=0)
    c = blk["norm"].shape[0]
    x = np.random.default_rng(0).normal(size=(2, t, c)).astype(np.float32)
    ref = fused_convnext_block(jnp.asarray(x), *_args(blk), block_t=block_t,
                               interpret=True)
    tblk = bridge.params_from_jax(jax.tree.map(np.asarray, blk), device="cpu")
    got = convnext_block(torch.tensor(x), *_args(tblk))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the unfused block (the CPU and f32 path) computes the same function
    unfused = sigmavae._block(torch.tensor(x), tblk, sigmavae.SigmaVAEConfig())
    np.testing.assert_allclose(unfused.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def codec():
    jcfg = jvae.SigmaVAEConfig.tiny()
    jp = jvae.init_params(jcfg, jax.random.key(3))
    tcodec = Codec("sigma", sigmavae.SigmaVAEConfig.tiny(),
                   bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return jcfg, jp, tcodec


@pytest.mark.parametrize("layout", ["btd", "bdt", "square"])
def test_decode_matches_jax(codec, layout):
    jcfg, jp, tcodec = codec
    d = jcfg.latent_dim
    t = d if layout == "square" else 5
    z = np.random.default_rng(1).normal(size=(2, t, d)).astype(np.float32)
    if layout != "btd":  # (B, d, T); a square is read this way too
        z = np.ascontiguousarray(z.transpose(0, 2, 1))
    ref = np.asarray(jvae.decode(jp, jcfg, jnp.asarray(z)))
    got = sigmavae.decode(tcodec.params, tcodec.cfg, torch.tensor(z))
    assert got.shape == (2, 1, t * jcfg.hop)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if layout == "btd":
        np.testing.assert_allclose(tcodec.decode_latents(z), ref, **TOL)


def test_codec_init_tree_matches_jax(codec):
    jcfg, jp, _ = codec
    got = Codec.random_init("sigma", device="cpu", cfg=sigmavae.SigmaVAEConfig.tiny())
    assert bridge.tree_map(lambda t: tuple(t.shape), got.params) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert got.samples_per_frame == jcfg.hop and got.sample_rate == 24000
