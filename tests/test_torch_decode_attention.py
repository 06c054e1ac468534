"""K1 parity: the plain version of the port's decode attention against the
JAX Pallas kernel `decode_attention_cached` in interpret mode, on the cases
tests/test_decode_attention.py holds the kernel to: layer selection, int8
scales over one and several cache blocks, a fully masked trailing block,
bf16 I/O. Tolerances as there: 1e-5 / 1e-4 in f32, 1e-4 / 1e-3 for int8,
2e-2 for bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas.decode_attention import decode_attention_cached as jax_kernel
from kalle_tpu_torch.ops.kernels import decode_attention as k1


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(L, b, c, nq, nkv, hd, seed, holes=True):
    """Stacked cache in the kernel layout + a decode mask with left-pad holes."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    kt = rng.normal(size=(L, b, nkv, hd, c)).astype(np.float32)
    v = rng.normal(size=(L, b, nkv, c, hd)).astype(np.float32)
    mask = np.zeros((b, c), bool)
    for i in range(b):
        n_valid = rng.integers(1, c + 1)
        mask[i, :n_valid] = True
        if holes and n_valid > 2:
            mask[i, : rng.integers(0, n_valid - 1)] = False
            mask[i, 0] = True
    return q, kt, v, mask


def _quant(x, axis):
    absmax = np.abs(x).max(axis=axis, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


def _both(q, kt, v, li, mask, ks=None, vs=None):
    j = jax_kernel(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), li, jnp.asarray(mask),
                   k_scale=None if ks is None else jnp.asarray(ks),
                   v_scale=None if vs is None else jnp.asarray(vs), interpret=True)
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    got = k1.decode_attention_cached(t(q), t(kt), t(v), li, t(mask), t(ks), t(vs))
    return got, np.asarray(j, np.float32)


def test_layer_selection_flagship_heads():
    """Layer li of a 3-layer cache, flagship head geometry (32 q / 8 kv, hd 64)."""
    q, kt, v, mask = _case(3, 2, 128, 32, 8, 64, seed=10)
    for li in (0, 2):
        got, ref = _both(q, kt, v, li, mask)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("c", [128, 384])
def test_int8_scales(c):
    """int8 K/V with per-(token, head) scales over one and several blocks."""
    q, kt, v, mask = _case(1, 2, c, 8, 2, 16, seed=8)
    kq, ks = _quant(kt, axis=3)                      # (L, b, nkv, 1, C)
    vq, vs = _quant(v, axis=4)                       # (L, b, nkv, C, 1)
    vs = np.ascontiguousarray(np.swapaxes(vs, -1, -2))
    got, ref = _both(q, kq, vq, 0, mask, ks, vs)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-3)


def test_fully_masked_trailing_block():
    q, kt, v, mask = _case(1, 2, 256, 8, 2, 16, seed=4, holes=False)
    mask[:, 128:] = False
    mask[:, :8] = True
    got, ref = _both(q, kt, v, 0, mask)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-4)


def test_bf16_io():
    q, kt, v, mask = _case(1, 2, 128, 8, 2, 16, seed=5)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    j = jax_kernel(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kt, jnp.bfloat16),
                   jnp.asarray(v, jnp.bfloat16), 0, jnp.asarray(mask), interpret=True)
    from kalle_tpu_torch import bridge

    tq, tk, tv = (bridge.params_from_jax(bf(a), device="cpu") for a in (q, kt, v))
    got = k1.decode_attention_cached(tq, tk, tv, 0, torch.tensor(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(j, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_wrapper_never_falls_back():
    """Tensors neither all on the CPU nor all on a CUDA card raise instead
    of silently taking the plain version."""
    q, kt, v, mask = _case(1, 1, 128, 4, 2, 8, seed=1)
    meta = [torch.empty(a.shape, device="meta") for a in (q, kt, v)]
    with pytest.raises(ValueError):
        k1.decode_attention_cached(*meta, 0, torch.tensor(mask))
