"""Port parity: the Llama backbone and the Llasa heads of kalle_tpu_torch
against kalle_tpu on the tiny configs (CPU, f32, atol 1e-5 / rtol 1e-4 as
tests/test_decode_attention.py:45). Weights go across through
bridge.params_from_jax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.models.lm import llama as jllama
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops import quant as jquant
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.models.lm import llama, llasa

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.LlasaConfig.tiny()
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, config.LlasaConfig.tiny(), bridge.params_from_jax(
        _np_tree(jp), device="cpu")


@pytest.mark.parametrize("scaled", [True, False])
def test_rope(scaled):
    jcfg = jconfig.LlamaConfig(head_dim=64) if scaled else jconfig.LlamaConfig(
        head_dim=64, rope_scaling=None)
    tcfg = config.LlamaConfig(head_dim=64) if scaled else config.LlamaConfig(
        head_dim=64, rope_scaling=None)
    np.testing.assert_allclose(llama.rope_inv_freq(tcfg).numpy(),
                               np.asarray(jllama.rope_inv_freq(jcfg)), rtol=1e-6)
    pos = np.array([[0, 1, 5, 40], [3, 3, 9, 127]], np.int32)
    x = np.random.default_rng(0).normal(size=(2, 4, 3, 64)).astype(np.float32)
    jc, js = jllama.rope_cos_sin(jcfg, jnp.asarray(pos))
    tc, ts = llama.rope_cos_sin(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    ref = np.asarray(jllama.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(llama.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               ref, **TOL)


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    ref = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_layer_without_cache(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    b, t, h = 2, 5, jcfg.llama.hidden_size
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    pad = np.ones((b, t), np.int32)
    pad[1, :2] = 0
    jmask = jllama.make_causal_padding_mask(jnp.asarray(pad), t)
    jc, js = jllama.rope_cos_sin(jcfg.llama, jnp.arange(t))
    jlp = jax.tree.map(lambda a: a[1], jp["llama"]["layers"])
    ref, _ = jllama._layer(jcfg.llama, jnp.asarray(x), jlp, jc, js, jmask)
    tc, ts = llama.rope_cos_sin(tcfg.llama, torch.arange(t))
    got = llama._layer(tcfg.llama, torch.from_numpy(x),
                       llama.layer_params(tp["llama"]["layers"])[1], tc, ts,
                       torch.tensor(np.asarray(jmask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("int8_weights", [False, True])
def test_forward_with_cache_prefill_and_decode(model, kv, int8_weights):
    """Left-padded prefill, then two t=1 decode steps (the port's kernel
    dispatch, plain versions on CPU) against the JAX cache path."""
    jcfg, jp, tcfg, tp = model
    jl = dataclasses.replace(jcfg.llama, kv_cache_dtype=kv)
    tl = dataclasses.replace(tcfg.llama, kv_cache_dtype=kv)
    jparams, tparams = jp["llama"], tp["llama"]
    if int8_weights:
        jparams = jquant.quantize_llama_params(jparams)
        tparams = bridge.params_from_jax(_np_tree(jparams), device="cpu")
    rng = np.random.default_rng(3)
    b, t, h, C = 2, 6, jl.hidden_size, 128
    emb = rng.normal(size=(b, t + 2, h)).astype(np.float32)
    valid = np.zeros((b, C), bool)
    valid[:, :t] = True
    valid[1, :3] = False  # row 1 left-padded by 3
    pos = np.maximum(np.arange(t)[None] - np.array([[0], [3]]), 0)

    jcache = jllama.KVCache.zeros(jl, b, C)
    tcache = llama.KVCache.zeros(tl, b, C, device="cpu")
    steps = [(emb[:, :t], pos)] + [(emb[:, t + i: t + i + 1], pos[:, -1:] + 1 + i)
                                   for i in range(2)]
    for i, (e, p) in enumerate(steps):
        if i:
            valid[:, t + i - 1] = True
        ref, jcache = jllama.forward_with_cache(jparams, jl, jnp.asarray(e), jcache,
                                                jnp.asarray(valid), jnp.asarray(p))
        got, tcache = llama.forward_with_cache(tparams, tl, torch.from_numpy(e), tcache,
                                               torch.from_numpy(valid), torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tcache.length == int(jcache.length) == t + 2


def test_llasa_heads(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 3, jcfg.latent_dim)).astype(np.float32)
    hid = rng.normal(size=(2, 3, jcfg.llama.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        llasa.audio_proj(tp, torch.from_numpy(lat), torch.float32).numpy(),
        np.asarray(jllasa.audio_proj(jp, jnp.asarray(lat), jnp.float32)), **TOL)
    head = llasa.distribution_head(tp, torch.from_numpy(hid), torch.float32)
    np.testing.assert_allclose(
        head.numpy(), np.asarray(jllasa.distribution_head(jp, jnp.asarray(hid), jnp.float32)),
        **TOL)
    std = np.full_like(lat, 0.5)
    np.testing.assert_allclose(
        llasa.end_kl(tcfg, torch.from_numpy(lat), torch.from_numpy(std)).numpy(),
        np.asarray(jllasa.end_kl(jcfg, jnp.asarray(lat), jnp.asarray(std))), **TOL)


def test_init_params_tree_matches_jax(model):
    """torch init builds the same tree, shapes and dtypes as the JAX init."""
    jcfg, jp, tcfg, _ = model
    got = llasa.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = bridge.tree_map(lambda t: tuple(t.shape), got)
    assert tshapes == jshapes
