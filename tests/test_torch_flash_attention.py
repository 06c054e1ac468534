"""K5-K7's plain versions (kalle_tpu_torch/ops/kernels/flash_attention.py)
against the JAX package's Pallas flash attention run in interpret mode on
the CPU (kalle_tpu/ops/pallas/flash_attention.py), on the same numpy-seeded
inputs. Tolerances as tests/test_flash_attention.py: O at rtol 2e-4 /
atol 2e-5 (:24), dQ/dK/dV at rtol 5e-4 / atol 5e-5 (:89). The CUDA kernels
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas import flash_attention as jfa
from kalle_tpu_torch.ops.kernels import flash_attention as fa

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=5e-4, atol=5e-5)

# (b, t, nq, nkv, hd): GQA g=2 over two 128-blocks; a single block, no GQA
CASES = {"t256_gqa": (3, 256, 4, 2, 16), "t128_mha": (2, 128, 2, 2, 32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, nkv, hd)).astype(np.float32)
    w = rng.normal(size=(b, t, nq, hd)).astype(np.float32)  # the output cotangent
    pad = np.ones((b, t), np.int32)
    pad[0, t - 56:] = 0  # ragged right tail
    pad[1, :40] = 0      # left padded: queries 0..39 see no valid key
    if b > 2:
        pad[2] = 0       # a row with no valid key at all
    return q, k, v, w, pad


@pytest.fixture(scope="module")
def jax_ref():
    """One interpret-mode JAX evaluation per case: O, LSE and the grads of
    sum(O * w)."""
    out = {}
    for name, shape in CASES.items():
        q, k, v, w, pad = _inputs(*shape)
        jq, jk, jv, jw = map(jnp.asarray, (q, k, v, w))
        jpad = jnp.asarray(pad)
        o, res = jfa._fwd(jq, jk, jv, jpad.astype(jnp.float32), 128, 128, True)
        b, t, nq, _ = q.shape
        lse = np.asarray(res[-1]).reshape(b, nq, t)

        def loss(q_, k_, v_):
            return jnp.sum(jfa.flash_attention(q_, k_, v_, jpad, interpret=True) * jw)

        grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
        out[name] = (np.asarray(o), lse, [np.asarray(g) for g in grads])
    return out


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(jax_ref, case):
    q, k, v, _, pad = _torch(*_inputs(*CASES[case]))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pad)
    o_ref, lse_ref, _ = jax_ref[case]
    np.testing.assert_allclose(o.numpy(), o_ref, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **FWD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_grad(jax_ref, case):
    q, k, v, w, pad = _torch(*_inputs(*CASES[case]))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pad)
    grads = fa.flash_attention_bwd_plain(q, k, v, pad, o, lse, w)
    for name, got, ref in zip("qkv", grads, jax_ref[case][2]):
        np.testing.assert_allclose(got.numpy(), ref, **BWD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_autograd_function_matches_jax_grad(jax_ref, case):
    """flash_attention (the autograd.Function the model calls) on CPU
    tensors: its backward is the plain K6/K7."""
    q, k, v, w, pad = _torch(*_inputs(*CASES[case]))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(q, k, v, pad)
    grads = torch.autograd.grad(o, (q, k, v), w)
    np.testing.assert_allclose(o.detach().numpy(), jax_ref[case][0], **FWD_TOL)
    for name, got, ref in zip("qkv", grads, jax_ref[case][2]):
        np.testing.assert_allclose(got.numpy(), ref, **BWD_TOL, err_msg=f"d{name}")


def test_backward_plain_equals_autograd_through_forward():
    """The written-out backward is the derivative of the plain forward."""
    q, k, v, w, pad = _torch(*_inputs(3, 64, 4, 2, 16, seed=5))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pad)
    auto = torch.autograd.grad(o, (q, k, v), w)
    written = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), pad,
                                           o.detach(), lse.detach(), w)
    for a, b in zip(auto, written):  # f32, summed in other orders
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_fully_masked_rows():
    """Rows with no valid key: O = 0, LSE = -1e30, and no gradient flows
    through them (the TPU kernel's masked-row semantics)."""
    q, k, v, w, pad = _torch(*_inputs(3, 128, 4, 2, 16, seed=2))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pad)
    assert torch.all(o[2] == 0) and torch.all(o[1, :40] == 0)
    assert torch.all(lse[2] == fa.NEG) and torch.all(lse[1, :, :40] == fa.NEG)
    assert torch.all(lse[1, :, 40:] > -1e3)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, pad, o, lse, w)
    assert torch.all(dq[2] == 0) and torch.all(dk[2] == 0) and torch.all(dv[2] == 0)
    assert torch.all(dq[1, :40] == 0) and torch.all(dk[1, :40] == 0)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dtypes_follow_the_inputs(dtype):
    q, k, v, w, pad = _torch(*_inputs(2, 128, 4, 2, 16, seed=3))
    q, k, v, w = (x.to(dtype) for x in (q, k, v, w))
    o, lse = fa.flash_fwd(q, k, v, pad)
    assert o.dtype == dtype and lse.dtype == torch.float32
    delta = fa.attention_delta(o, w)
    assert fa.flash_bwd_dq(q, k, v, pad, w, lse, delta).dtype == dtype
    assert all(x.dtype == dtype for x in fa.flash_bwd_dkv(q, k, v, pad, w, lse, delta))


def test_rejects_unbucketed_lengths():
    q = torch.zeros(1, 200, 2, 16)
    k = torch.zeros(1, 200, 2, 16)
    with pytest.raises(ValueError, match="multiple of the block"):
        fa.flash_attention(q, k, k, torch.ones(1, 200))
