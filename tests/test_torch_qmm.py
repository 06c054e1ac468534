"""K2/K3 parity: the plain versions of the port's `qmm` and `fused_mlp`
against the JAX Pallas kernels in interpret mode (tests/test_qmm.py:
atol/rtol 1e-5 for qmm, 2e-4 for fused_mlp)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas.qmm import fused_mlp as jax_fused_mlp
from kalle_tpu.ops.pallas.qmm import qmm as jax_qmm
from kalle_tpu.ops.quant import quantize_weight
from kalle_tpu_torch.ops.kernels import qmm as k23


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _tw(w):
    return {k: _t(v) for k, v in w.items()} if isinstance(w, dict) else _t(w)


@pytest.mark.parametrize("quant", [True, False])
def test_qmm(quant):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(256, 512)) * 0.02).astype(np.float32)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    jw = quantize_weight(jnp.asarray(w)) if quant else {"q": jnp.asarray(w), "scale": None}
    ref = jax_qmm(jnp.asarray(x), jw["q"], jw["scale"], block_n=128, interpret=True)
    got = k23.qmm(_t(x), _t(jw["q"]), None if jw["scale"] is None else _t(jw["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quant", [True, False])
def test_fused_mlp(quant):
    rng = np.random.default_rng(1)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in ((128, 512), (128, 512), (512, 128))]
    x = rng.normal(size=(8, 128)).astype(np.float32)
    jws = [quantize_weight(jnp.asarray(w)) if quant else jnp.asarray(w) for w in ws]
    ref = jax_fused_mlp(jnp.asarray(x), *jws, block_f=128, interpret=True)
    got = k23.fused_mlp(_t(x), *(_tw(w) for w in jws))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_wrappers_reject_mixed_devices():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        k23.qmm(x, torch.zeros(64, 32, device="meta"))
    with pytest.raises(ValueError):
        k23.fused_mlp(x, torch.zeros(64, 64, device="meta"), torch.zeros(64, 64),
                      torch.zeros(64, 64))
