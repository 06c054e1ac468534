"""C3's inputs on the CPU: the plain versions that the card's kernels are
held to, against the JAX package, where the card used to raise.

- K1 at 16 query heads a KV head and hd 256 (B 2, nq 32, nkv 2, C 128):
  `decode_attention_plain` against JAX `decode_attention_cached` in
  interpret mode, base, int8 cache and sideband (f32: 1e-5; the int8 cache
  at test_torch_decode_attention.py's 1e-4 / 1e-3).
- K2/K3 with f32 activations and int8 weights: `qmm_plain` and
  `fused_mlp_plain` against JAX `qmm` and `fused_mlp` in interpret mode
  (1e-5).
- A greedy `generate` of `quantize_llama_params(LlamaConfig.tiny())` in
  f32 against JAX's (1e-4), its decode matmuls routed to the K2/K3
  wrappers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.infer.generate import generate as jgenerate
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops.pallas.decode_attention import decode_attention_cached as jax_k1
from kalle_tpu.ops.pallas.qmm import fused_mlp as jax_fused_mlp
from kalle_tpu.ops.pallas.qmm import qmm as jax_qmm
from kalle_tpu.ops.quant import quantize_llama_params as jquantize
from kalle_tpu.ops.quant import quantize_weight
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.models.lm import llama
from kalle_tpu_torch.ops.kernels import decode_attention as k1
from kalle_tpu_torch.ops.kernels import qmm as k23


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wide_case(seed, L=2, b=2, nq=32, nkv=2, hd=256, c=128):
    """A stacked cache at C3's geometry and a mask with left-pad holes and
    one row valid on a prefix only."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    kt = rng.normal(size=(L, b, nkv, hd, c)).astype(np.float32)
    v = rng.normal(size=(L, b, nkv, c, hd)).astype(np.float32)
    kn = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    vn = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    mask = np.zeros((b, c), bool)
    mask[0, 5:100] = True
    mask[1, :c - 3] = True
    return q, kt, v, kn, vn, mask


def _quant(x, axis):
    absmax = np.abs(x).max(axis=axis, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("mode", ["base", "int8", "sideband"])
def test_decode_attention_group16_hd256_matches_jax(mode):
    q, kt, v, kn, vn, mask = _wide_case(seed=16)
    li = 1
    kw = {}
    tol = dict(atol=1e-5, rtol=1e-5)
    if mode == "int8":
        kt, ks = _quant(kt, axis=3)                      # (L, b, nkv, 1, C)
        v, vs = _quant(v, axis=4)                        # (L, b, nkv, C, 1)
        kw = dict(k_scale=ks, v_scale=np.ascontiguousarray(np.swapaxes(vs, -1, -2)))
        tol = dict(atol=1e-4, rtol=1e-3)
    elif mode == "sideband":
        kw = dict(k_new=kn, v_new=vn, new_valid=np.array([True, False]))
    ref = jax_k1(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), li, jnp.asarray(mask),
                 interpret=True, **{k: jnp.asarray(a) for k, a in kw.items()})
    got = k1.decode_attention_cached(torch.tensor(q), torch.tensor(kt), torch.tensor(v), li,
                                     torch.tensor(mask),
                                     **{k: torch.tensor(a) for k, a in kw.items()})
    assert got.shape == (2, 32, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("m,k,n", [(3, 64, 128), (8, 256, 512)])
def test_qmm_f32_int8_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jw = quantize_weight(jnp.asarray(w))
    ref = jax_qmm(jnp.asarray(x), jw["q"], jw["scale"], block_n=n, interpret=True)
    got = k23.qmm_plain(torch.tensor(x), torch.tensor(np.asarray(jw["q"])),
                        torch.tensor(np.asarray(jw["scale"])))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,h,f", [(3, 64, 128), (9, 128, 256)])
def test_fused_mlp_f32_int8_matches_jax(m, h, f):
    rng = np.random.default_rng(m + h)
    ws = [quantize_weight(jnp.asarray((rng.normal(size=s) * 0.05).astype(np.float32)))
          for s in ((h, f), (h, f), (f, h))]
    x = rng.normal(size=(m, h)).astype(np.float32)
    ref = jax_fused_mlp(jnp.asarray(x), *ws, block_f=f, interpret=True)
    got = k23.fused_mlp_plain(torch.tensor(x), *({k: torch.tensor(np.asarray(a))
                                                  for k, a in w.items()} for w in ws))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_generate_tiny_int8_f32_matches_jax(monkeypatch):
    """Greedy decoding of the tiny f32 config with int8 layer weights: every
    decode matmul goes to the K2/K3 wrappers (their plain versions on the
    CPU), and the frames agree with JAX's at 1e-4."""
    jcfg = jconfig.LlasaConfig.tiny()
    jp = jquantize(jllasa.init_params(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 300, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), np.int32)
    mask[2, :3] = 0
    ids[mask == 0] = 0
    calls = {"qmm": 0, "fused_mlp": 0}

    def counted(name, fn):
        def call(x, *args):
            assert x.dtype == torch.float32
            calls[name] += 1
            return fn(x, *args)
        return call

    monkeypatch.setattr(llama, "qmm", counted("qmm", k23.qmm))
    monkeypatch.setattr(llama, "fused_mlp", counted("fused_mlp", k23.fused_mlp))
    frames = 6
    ref = jgenerate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(1),
                    max_frames=frames, greedy=True)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = generate(tp, config.LlasaConfig.tiny(), torch.tensor(ids), torch.tensor(mask),
                   max_frames=frames, greedy=True)
    layers = jcfg.llama.num_layers
    assert calls == {"qmm": 4 * layers * frames, "fused_mlp": layers * frames}
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    for name in ("means", "samples"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
