"""Port parity: ops/attention, ops/quant, ops/conv and the param bridge of
kalle_tpu_torch against kalle_tpu on the same numpy inputs (CPU, f32).

Tolerance atol 1e-5 / rtol 1e-4 for f32 modules, as
tests/test_decode_attention.py:45 holds the JAX attention paths."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kalle_tpu.ops import attention as jatt
from kalle_tpu.ops import conv as jconv
from kalle_tpu.ops import quant as jquant
from kalle_tpu_torch import bridge
from kalle_tpu_torch.ops import attention, conv, quant

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _mask(rng, b, tq, tkv):
    pad = np.ones((b, tkv), np.int32)
    pad[0, :2] = 0  # left pads on row 0
    return pad, np.asarray(jatt.make_causal_padding_mask(jnp.asarray(pad), tq,
                                                         q_offset=tkv - tq))


def test_causal_padding_mask():
    rng = np.random.default_rng(0)
    pad, ref = _mask(rng, 2, 3, 7)
    got = attention.make_causal_padding_mask(_t(pad), 3, q_offset=4)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("nq,nkv", [(8, 2), (4, 4)])
def test_mha_and_mha_t(nq, nkv):
    rng = np.random.default_rng(1)
    b, tq, tkv, hd = 2, 3, 7, 16
    q = rng.normal(size=(b, tq, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, tkv, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, tkv, nkv, hd)).astype(np.float32)
    _, mask = _mask(rng, b, tq, tkv)
    ref = np.asarray(jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask)))
    got = attention.mha(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    kt = np.ascontiguousarray(k.transpose(0, 2, 3, 1))
    vt = np.ascontiguousarray(v.transpose(0, 2, 1, 3))
    ref_t = np.asarray(jatt.mha_t(jnp.asarray(q), jnp.asarray(kt),
                                  jnp.asarray(vt), jnp.asarray(mask)))
    got_t = attention.mha_t(_t(q), _t(kt), _t(vt), _t(mask))
    np.testing.assert_allclose(got_t.numpy(), ref_t, **TOL)


def test_quantize_weight_and_qmatmul():
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(64, 96)) * 0.02).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = quant.quantize_weight(_t(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_allclose(tw["scale"].numpy(), np.asarray(jw["scale"]), rtol=1e-6)
    ref = np.asarray(jquant.qmatmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(quant.qmatmul(_t(x), tw).numpy(), ref, **TOL)
    np.testing.assert_allclose(quant.maybe_matmul(_t(x), tw).numpy(), ref, **TOL)
    np.testing.assert_allclose(quant.maybe_matmul(_t(x), _t(w)).numpy(), x @ w, **TOL)
    assert quant.is_quantized(tw) and not quant.is_quantized(_t(w))


def test_quantize_llama_params():
    rng = np.random.default_rng(3)
    L, h, f = 2, 32, 64
    shapes = {"wq": (h, h), "wk": (h, 16), "wv": (h, 16), "wo": (h, h),
              "wg": (h, f), "wu": (h, f), "wd": (f, h)}
    layers = {k: (rng.normal(size=(L,) + s) * 0.02).astype(np.float32)
              for k, s in shapes.items()}
    layers["attn_norm"] = np.ones((L, h), np.float32)
    tree = {"llama": {"layers": layers, "embed": np.zeros((4, h), np.float32)}}
    jq = jquant.quantize_llama_params(jax.tree.map(jnp.asarray, tree))
    tq = quant.quantize_llama_params(bridge.params_from_jax(tree, device="cpu"))
    for k in shapes:
        np.testing.assert_array_equal(tq["llama"]["layers"][k]["q"].numpy(),
                                      np.asarray(jq["llama"]["layers"][k]["q"]))
        np.testing.assert_allclose(tq["llama"]["layers"][k]["scale"].numpy(),
                                   np.asarray(jq["llama"]["layers"][k]["scale"]), rtol=1e-6)
    bare = quant.quantize_llama_params(bridge.params_from_jax(tree["llama"], device="cpu"))
    assert quant.is_quantized(bare["layers"]["wd"])
    assert not quant.is_quantized(bare["layers"]["attn_norm"])


@pytest.mark.parametrize("k,stride,padding,groups", [
    (7, 1, (6, 0), 1),   # causal
    (3, 1, 1, 1),        # symmetric
    (8, 4, (4, 0), 1),   # strided causal downsample
    (7, 1, (6, 0), 6),   # depthwise
])
def test_conv1d(k, stride, padding, groups):
    rng = np.random.default_rng(4)
    cin, cout = 6, 6 if groups > 1 else 5
    x = rng.normal(size=(2, 24, cin)).astype(np.float32)
    w = rng.normal(size=(k, cin // groups, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=stride, padding=padding, groups=groups))
    got = conv.conv1d(_t(x), _t(w), _t(b), stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride", [2, 4, 5])
def test_conv_transpose1d_causal(stride):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(2 * stride, 6, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    ref = np.asarray(jconv.conv_transpose1d_causal(jnp.asarray(x), jnp.asarray(w),
                                                   jnp.asarray(b), stride=stride))
    got = conv.conv_transpose1d_causal(_t(x), _t(w), _t(b), stride=stride)
    assert got.shape == (2, 9 * stride, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_bridge_keeps_structure_and_bits():
    rng = np.random.default_rng(6)
    tree = {"a": [rng.normal(size=(3,)).astype(np.float32),
                  rng.integers(-127, 127, (2, 2)).astype(np.int8)],
            "b": {"c": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16)}}
    got = bridge.params_from_jax(tree, device="cpu")
    assert got["a"][0].dtype == torch.float32 and got["a"][1].dtype == torch.int8
    assert got["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"]["c"].float().numpy(),
                                  tree["b"]["c"].astype(np.float32))
    np.testing.assert_array_equal(got["a"][1].numpy(), tree["a"][1])
    cast = bridge.params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["a"][0].dtype == torch.bfloat16 and cast["a"][1].dtype == torch.int8
