"""The widths the kernels now take (C1, C2) and the decode step's route.

  * K2/K3 at more than 64 rows (a decode batch above 64): the plain
    versions against the JAX Pallas kernels in interpret mode (atol/rtol
    1e-5 for qmm, 2e-4 for fused_mlp, as tests/test_qmm.py).
  * K4 at the tiny codec's widths (C 4 and 8) and at mlp_ratio 3: the
    plain version against `fused_convnext_block` in interpret mode, and the
    whole SigmaVAE decode at mlp_ratio 3 against JAX (f32, atol/rtol 1e-5,
    as tests/test_fused_block.py).
  * The route chosen at the call site: int8 layer weights stream through
    K2/K3 in a decode step; dense weights take `maybe_matmul` there, as the
    JAX decode leaves them to XLA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import sigmavae as jvae
from kalle_tpu.ops.pallas.convnext_block import fused_convnext_block
from kalle_tpu.ops.pallas.qmm import fused_mlp as jax_fused_mlp
from kalle_tpu.ops.pallas.qmm import qmm as jax_qmm
from kalle_tpu.ops.quant import quantize_weight
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlasaConfig
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.models.lm import llama, llasa
from kalle_tpu_torch.ops.kernels import qmm as k23
from kalle_tpu_torch.ops.kernels.convnext_block import convnext_block
from kalle_tpu_torch.ops.quant import quantize_llama_params


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("m", [72, 130])
@pytest.mark.parametrize("quant", [True, False])
def test_qmm_many_rows_matches_jax(m, quant):
    rng = np.random.default_rng(m)
    w = (rng.normal(size=(128, 256)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, 128)).astype(np.float32)
    jw = quantize_weight(jnp.asarray(w)) if quant else {"q": jnp.asarray(w), "scale": None}
    ref = jax_qmm(jnp.asarray(x), jw["q"], jw["scale"], block_n=128, interpret=True)
    got = k23.qmm(_t(x), _t(jw["q"]), None if jw["scale"] is None else _t(jw["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,h", [(72, 128), (80, 64)])
def test_fused_mlp_many_rows_matches_jax(m, h):
    rng = np.random.default_rng(h)
    f = 256
    ws = [quantize_weight(jnp.asarray((rng.normal(size=s) * 0.05).astype(np.float32)))
          for s in ((h, f), (h, f), (f, h))]
    x = rng.normal(size=(m, h)).astype(np.float32)
    ref = jax_fused_mlp(jnp.asarray(x), *ws, block_f=128, interpret=True)
    got = k23.fused_mlp(_t(x), *({k: _t(v) for k, v in w.items()} for w in ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("channels,mlp_ratio", [((4, 8), 2), ((8, 4), 2), ((8, 16), 3)])
def test_block_any_width_matches_jax_kernel(channels, mlp_ratio):
    cfg = jvae.SigmaVAEConfig(latent_dim=8, strides=(2, 4), channels=channels,
                              blocks_per_stage=1, mlp_ratio=mlp_ratio)
    blk = jvae.init_params(cfg, jax.random.key(1))["decoder"]["stages"][0]["blocks"][0]
    c = blk["norm"].shape[0]
    assert blk["down"]["w"].shape[1] == mlp_ratio * c
    x = np.random.default_rng(0).normal(size=(2, 48, c)).astype(np.float32)
    args = (blk["norm"], blk["dw"]["w"], blk["dw"]["b"], blk["up"]["w"], blk["up"]["b"],
            blk["down"]["w"], blk["down"]["b"])
    ref = fused_convnext_block(jnp.asarray(x), *args, block_t=16, interpret=True)
    targs = bridge.params_from_jax([np.asarray(a) for a in args], device="cpu")
    got = convnext_block(torch.tensor(x), *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_decode_mlp_ratio_3_matches_jax():
    jcfg = dataclasses.replace(jvae.SigmaVAEConfig.tiny(), mlp_ratio=3)
    jp = jvae.init_params(jcfg, jax.random.key(4))
    tcfg = dataclasses.replace(sigmavae.SigmaVAEConfig.tiny(), mlp_ratio=3)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    z = np.random.default_rng(2).normal(size=(2, 5, jcfg.latent_dim)).astype(np.float32)
    ref = np.asarray(jvae.decode(jp, jcfg, jnp.asarray(z)))
    got = sigmavae.decode(tp, tcfg, torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quant", [True, False])
def test_decode_route_follows_the_weights(monkeypatch, quant):
    """A t=1 step sends int8 weights to K2 (wq, wk, wv, wo) and K3 (the MLP)
    in every layer; with dense weights neither wrapper is called."""
    calls = {"qmm": 0, "fused_mlp": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(llama, "qmm", spy("qmm", llama.qmm))
    monkeypatch.setattr(llama, "fused_mlp", spy("fused_mlp", llama.fused_mlp))
    cfg = LlasaConfig.tiny()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if quant:
        params = quantize_llama_params(params)
    ids = torch.randint(0, 300, (2, 5), generator=torch.Generator().manual_seed(1))
    res = generate(params, cfg, ids, torch.ones_like(ids), max_frames=3, greedy=True)
    assert torch.isfinite(res.means).all()
    L, steps = cfg.llama.num_layers, 3
    assert calls == ({"qmm": 4 * L * steps, "fused_mlp": L * steps} if quant
                     else {"qmm": 0, "fused_mlp": 0})
