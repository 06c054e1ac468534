"""K1's serving sideband: the plain version of the port's
`decode_attention_cached(..., k_new, v_new, new_valid)` against the JAX
Pallas kernel in interpret mode — rows whose new column does not count, a
row with no valid key before this step, one cache block (C 128) and the
online path over two (C 256). Tolerances: 1e-5 / 1e-4 in f32 (as
tests/test_decode_attention.py:203), 2e-2 in bf16 (:79). Also the
single-layer wrapper `decode_attention` and the sideband's contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas.decode_attention import decode_attention as jax_single
from kalle_tpu.ops.pallas.decode_attention import decode_attention_cached as jax_kernel
from kalle_tpu_torch import bridge
from kalle_tpu_torch.ops.kernels import decode_attention as k1


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serving_case(c, seed, L=2, nq=8, nkv=2, hd=16):
    """A serving step: row i's cache is valid on [pads_i, lengths_i) (a
    left-padded prompt and its frames) and its new column goes to slot
    lengths_i. Row 3 has no valid key before this step and a live column;
    row 4 none and a dead one; row 2's column does not count."""
    rng = np.random.default_rng(seed)
    b = 5
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    kt = rng.normal(size=(L, b, nkv, hd, c)).astype(np.float32)
    v = rng.normal(size=(L, b, nkv, c, hd)).astype(np.float32)
    k_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, nkv, hd)).astype(np.float32)
    lengths = np.array([9, c // 2 + 3, c - 1, 0, 0])
    pads = np.array([3, 5, 0, 0, 0])
    mask = np.zeros((b, c), bool)
    for i in range(b):
        mask[i, pads[i]:lengths[i]] = True
    live = np.array([True, True, False, True, False])
    return q, kt, v, mask, k_new, v_new, live, lengths


def _jax(q, kt, v, li, mask, kn, vn, live, dtype=jnp.float32):
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    out = jax_kernel(a(q), a(kt), a(v), li, jnp.asarray(mask), k_new=a(kn), v_new=a(vn),
                     new_valid=jnp.asarray(live), interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("li", [0, 1])
def test_sideband_f32_matches_jax(c, li):
    q, kt, v, mask, kn, vn, live, _ = _serving_case(c, seed=c + li)
    ref = _jax(q, kt, v, li, mask, kn, vn, live)
    t = torch.tensor
    got = k1.decode_attention_cached(t(q), t(kt), t(v), li, t(mask), k_new=t(kn),
                                     v_new=t(vn), new_valid=t(live))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("c", [128, 256])
def test_sideband_bf16_matches_jax(c):
    q, kt, v, mask, kn, vn, live, _ = _serving_case(c, seed=7)
    ref = _jax(q, kt, v, 1, mask, kn, vn, live, jnp.bfloat16)
    bf = lambda a: bridge.params_from_jax(np.asarray(jnp.asarray(a, jnp.bfloat16)),  # noqa: E731
                                          device="cpu")
    got = k1.decode_attention_cached(bf(q), bf(kt), bf(v), 1, torch.tensor(mask),
                                     k_new=bf(kn), v_new=bf(vn), new_valid=torch.tensor(live))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("c", [128, 256])
def test_sideband_equals_attention_after_the_write(c):
    """The sideband over the pre-write cache computes what the base mode
    computes over the cache with the column written at each row's slot and
    marked valid where it counts — for every row that has a valid key."""
    q, kt, v, mask, kn, vn, live, lengths = _serving_case(c, seed=3)
    t = torch.tensor
    got = k1.decode_attention_cached(t(q), t(kt), t(v), 0, t(mask), k_new=t(kn),
                                     v_new=t(vn), new_valid=t(live))
    kt2, v2, post = kt.copy(), v.copy(), mask.copy()
    for i in range(len(lengths)):
        kt2[0, i, :, :, lengths[i]] = kn[i]
        v2[0, i, :, lengths[i], :] = vn[i]
        post[i, lengths[i]] |= live[i]
    ref = k1.decode_attention_cached(t(q), t(kt2), t(v2), 0, t(post))
    has_key = post.any(axis=1)
    np.testing.assert_allclose(got.numpy()[has_key], ref.numpy()[has_key],
                               atol=1e-5, rtol=1e-4)


def test_single_layer_wrapper_matches_jax():
    q, kt, v, mask, *_ = _serving_case(256, seed=11)
    ref = jax_single(jnp.asarray(q), jnp.asarray(kt[1]), jnp.asarray(v[1]),
                     jnp.asarray(mask), interpret=True)
    got = k1.decode_attention(torch.tensor(q), torch.tensor(kt[1]), torch.tensor(v[1]),
                              torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def test_sideband_contract():
    """All three sideband tensors or none, and no int8 cache with them (the
    JAX kernel asserts the same)."""
    q, kt, v, mask, kn, vn, live, _ = _serving_case(128, seed=5)
    t = torch.tensor
    scale = torch.ones(2, 5, 2, 1, 128)
    with pytest.raises(ValueError):
        k1.decode_attention_cached(t(q), t(kt).to(torch.int8), t(v).to(torch.int8), 0,
                                   t(mask), scale, scale, k_new=t(kn), v_new=t(vn),
                                   new_valid=t(live))
    with pytest.raises(ValueError):
        k1.decode_attention_cached(t(q), t(kt), t(v), 0, t(mask), k_new=t(kn))
