"""The rounding of K6's and K7's bf16 tensor-core instances
(kalle_tpu_torch/csrc/flash_attention.cu, `flash_dq_mma` and
`flash_dkv_mma`), written out as a torch function: bf16 inputs, scores,
p = exp(s - LSE) and dS = p (dP - delta) in f32, then P and dS rounded to
bf16 before the dV, dQ and dK products, which accumulate in f32. It is held
against `jax.grad` through the JAX package's Pallas flash attention in
interpret mode (kalle_tpu/ops/pallas/flash_attention.py) on the same
bf16-representable inputs, and against the port's f32 plain versions, at
the tolerance the card holds the kernels to (2e-2 abs + 2e-2 rel,
chip_smoke.py and tests/test_torch_cuda.py). The card itself is checked
there; this shows on the CPU that the two rounding points fit the
tolerance at the training head dim and at hd 16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas import flash_attention as jfa
from kalle_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=2e-2, rtol=2e-2)

# (b, t, nq, nkv, hd): the training head dim with 4 query heads a KV head,
# and hd 16 with 2
CASES = {"hd64_t256": (3, 256, 8, 2, 64), "hd16_t128": (3, 128, 4, 2, 16)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, nq, nkv, hd, seed=0):
    """bf16 q, k, v, dO and the int32 pad mask: a ragged right tail, a
    left-padded row (queries 0..39 see no valid key), a row with no valid
    key."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(b, t, nq, hd)).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, t, nkv, hd)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    pad = torch.ones(b, t, dtype=torch.int32)
    pad[0, t - 56:] = 0
    pad[1, :40] = 0
    pad[2] = 0
    return q, k, v, do, pad


def kernel_rounding_bwd(q, k, v, pad, do, lse, delta):
    """dq, dk, dv (bf16) with the kernels' rounding points."""
    b, t, nq, hd = q.shape
    nkv, scale = k.shape[2], hd ** -0.5
    qf, do_f = q.float(), do.float()
    kf, vf = (x.float().repeat_interleave(nq // nkv, dim=2) for x in (k, v))
    pos = torch.arange(t)
    mask = (pos[None, :] <= pos[:, None])[None, None] & pad.bool()[:, None, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do_f, vf) - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf).reshape(b, t, nkv, nq // nkv, hd).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, do_f).reshape(b, t, nkv, nq // nkv, hd).sum(3)
    return dq.bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


def _emulated(case):
    q, k, v, do, pad = _inputs(*CASES[case])
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pad)  # o in bf16, as K5 gives it
    args = (q, k, v, pad, do, lse, fa.attention_delta(o, do))
    return kernel_rounding_bwd(*args), args


@pytest.fixture(scope="module")
def jax_grads():
    """One interpret-mode jax.grad per case, in f32 on the bf16 inputs."""
    out = {}
    for case in CASES:
        q, k, v, do, pad = (x.float().numpy() for x in _inputs(*CASES[case]))
        jpad, jw = jnp.asarray(pad.astype(np.int32)), jnp.asarray(do)

        def loss(q_, k_, v_):
            return jnp.sum(jfa.flash_attention(q_, k_, v_, jpad, interpret=True) * jw)

        grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        out[case] = [np.asarray(g) for g in grads]
    return out


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_rounding_matches_jax_grad(jax_grads, case, grad):
    i = "dq dk dv".split().index(grad)
    got = _emulated(case)[0][i]
    np.testing.assert_allclose(got.float().numpy(), jax_grads[case][i], **TOL, err_msg=grad)


@pytest.mark.parametrize("case", CASES)
def test_kernel_rounding_within_card_tolerance_of_plain(case):
    """What the card compares: the kernels against the f32 plain versions;
    the dead rows stay exactly 0 through the rounding."""
    (dq, dk, dv), args = _emulated(case)
    pad, lse = args[3], args[5]
    ref = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkv_plain(*args))
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)
    dead_q = (lse <= fa.NEG / 2).transpose(1, 2)
    assert dead_q.any() and torch.all(dq[dead_q] == 0)
    assert torch.all(dk[pad == 0] == 0) and torch.all(dv[pad == 0] == 0)
