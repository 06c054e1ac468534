"""Int4 weights and the fused decode layout of the port (kalle_tpu_torch/
ops/quant.py, the fused wqkv/wgu branches of models/lm/llama.py and
infer/serve_loop.py, K3's fused mode's plain version) against the JAX
package, on the CPU at the tiny config.

  * int4: `quantize_weight_int4` and `quantize_llama_params(bits=4)` give
    JAX's values (int4 there, int8 here) and scales exactly; group-wise
    `qmatmul` at f32 1e-5; the bridge carries int4 leaves both ways;
  * `fuse_decode_params` gives JAX's trees (dense, int8, int4; Llasa and
    bare) exactly;
  * `forward_with_cache`, a left-padded prefill and two decode steps, with
    fused int8 / dense / int4 weights against JAX's (f32 1e-4, bf16 2e-2);
  * the ContinuousBatcher (prefill, insert, decode_step) on fused params
    against JAX's, greedy (the serving tests' 2e-3 / 2e-4);
  * `fused_mlp_plain` in the fused layout equals the unfused call bit for
    bit (the kernel's own check is on the card, tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.infer.serve_loop import ContinuousBatcher as JBatcher
from kalle_tpu.models.lm import llama as jllama
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops import quant as jquant
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
from kalle_tpu_torch.models.lm import llama
from kalle_tpu_torch.ops import quant
from kalle_tpu_torch.ops.kernels.qmm import fused_mlp_plain

GROUP = 32  # the tiny model's 64 / 128 inputs split into 2 / 4 groups


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.LlasaConfig(llama=jconfig.LlamaConfig.tiny(), latent_dim=8,
                               audio_proj_dim=64, head_variant="stableaudio",
                               end_kl_threshold=-1.0)
    tcfg = config.LlasaConfig(llama=config.LlamaConfig.tiny(), latent_dim=8,
                              audio_proj_dim=64, head_variant="stableaudio",
                              end_kl_threshold=-1.0)
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, tcfg, bridge.params_from_jax(_np(jp), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _layouts(jp, tp, kind):
    """(JAX params, port params) in layout `kind`."""
    if kind in ("int8", "int8_fused"):
        jp, tp = jquant.quantize_llama_params(jp), quant.quantize_llama_params(tp)
    elif kind in ("int4", "int4_fused"):
        jp = jquant.quantize_llama_params(jp, bits=4, group=GROUP)
        tp = quant.quantize_llama_params(tp, bits=4, group=GROUP)
    if kind.endswith("fused"):
        jp, tp = jquant.fuse_decode_params(jp), quant.fuse_decode_params(tp)
    return jp, tp


def _assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    ref = np.asarray(ref)
    ref = ref.astype(np.int8) if ref.dtype == ml_dtypes.int4 else ref
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=path)


def test_int4_weight_matches_jax():
    w = np.random.default_rng(0).normal(size=(128, 48)).astype(np.float32)
    ref = jquant.quantize_weight_int4(jnp.asarray(w), group=GROUP)
    got = quant.quantize_weight_int4(torch.from_numpy(w), group=GROUP)
    assert got["q"].dtype == torch.int8 and int(got["q"].abs().max()) <= 7
    _assert_trees_equal(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llama_params_matches_jax(model, bits):
    _, jp, _, tp = model
    ref = jquant.quantize_llama_params(jp, bits=bits, group=GROUP)
    got = quant.quantize_llama_params(tp, bits=bits, group=GROUP)
    _assert_trees_equal(got, ref)
    # bare trees too, and the bridge both ways (int4 leaves <-> int8 tensors)
    _assert_trees_equal(quant.quantize_llama_params(tp["llama"], bits=bits, group=GROUP),
                        ref["llama"])
    _assert_trees_equal(bridge.params_from_jax(_np(ref), device="cpu"), ref)
    back = bridge.params_to_numpy(got)
    want = ml_dtypes.int4 if bits == 4 else np.int8
    assert back["llama"]["layers"]["wq"]["q"].dtype == want
    np.testing.assert_array_equal(back["llama"]["layers"]["wq"]["q"],
                                  np.asarray(ref["llama"]["layers"]["wq"]["q"]))


@pytest.mark.parametrize("shape", [(5, 128), (2, 3, 128)])
def test_groupwise_qmatmul_matches_jax(shape):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(128, 40)).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    jw = jquant.quantize_weight_int4(jnp.asarray(w), group=GROUP)
    tw = quant.quantize_weight_int4(torch.from_numpy(w), group=GROUP)
    ref = np.asarray(jquant.qmatmul(jnp.asarray(x), jw))
    got = quant.qmatmul(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert quant.is_grouped(tw) and not quant.is_grouped(quant.quantize_weight(
        torch.from_numpy(w)))


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_fuse_decode_params_matches_jax(model, kind):
    _, jp, _, tp = model
    jq, tq = _layouts(jp, tp, kind)
    ref, got = jquant.fuse_decode_params(jq), quant.fuse_decode_params(tq)
    _assert_trees_equal(got, ref)
    assert "wq" not in got["llama"]["layers"] and "wg" not in got["llama"]["layers"]
    _assert_trees_equal(quant.fuse_decode_params(tq["llama"]), ref["llama"])
    assert "wq" in tq["llama"]["layers"]  # the input tree is left as it was


@pytest.mark.parametrize("kind,dtype", [
    (k, d) for k in ("int8_fused", "dense_fused") for d in ("float32", "bfloat16")]
    # JAX's CPU backend has no bf16 x bf16 -> f32 dot for the int4 einsum
    + [("int4", "float32"), ("int4_fused", "float32")])
def test_forward_with_cache_fused_and_int4(model, kind, dtype):
    """Left-padded prefill, then two t=1 decode steps (the port's routes:
    K2/K3's plain versions for int8, maybe_matmul for dense and int4)."""
    jcfg, jp, tcfg, tp = model
    jl = dataclasses.replace(jcfg.llama, dtype=dtype)
    tl = dataclasses.replace(tcfg.llama, dtype=dtype)
    jparams, tparams = jp["llama"], tp["llama"]
    if dtype == "bfloat16":  # a bf16 model: bf16 weights, each package quantizing them
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    jparams, tparams = _layouts(jparams, tparams, kind.replace("dense_", ""))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
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
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("kind", ["int8_fused", "dense_fused", "int4_fused"])
def test_batcher_on_fused_params_matches_jax(model, kind):
    jcfg, jp, tcfg, tp = model
    jq, tq = _layouts(jp, tp, kind.replace("dense_", ""))
    prompts = [np.random.default_rng(0).integers(1, 300, (n,)).astype(np.int32)
               for n in (5, 11, 7)]
    kw = dict(batch_size=2, max_frames=6, prompt_buckets=(8, 16), greedy=True)
    ref = {c.index: c for c in JBatcher(jq, jcfg, **kw).run(prompts)}
    got = {c.index: c for c in ContinuousBatcher(tq, tcfg, device="cpu", **kw).run(prompts)}
    assert sorted(got) == sorted(ref)
    for i in ref:
        assert got[i].n_frames == ref[i].n_frames
        np.testing.assert_allclose(got[i].means, np.asarray(ref[i].means),
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_plain_fused_equals_unfused(quantized, dtype):
    g = torch.Generator().manual_seed(4)
    H, F = 64, 192
    wg, wu, wd = (torch.randn(a, b, generator=g) * 0.1 for a, b in ((H, F), (H, F), (F, H)))
    x = torch.randn(7, H, generator=g).to(dtype)
    if quantized:
        wg, wu, wd = (quant.quantize_weight(w) for w in (wg, wu, wd))
        wgu = {"q": torch.cat([wg["q"], wu["q"]], 1),
               "scale": torch.cat([wg["scale"], wu["scale"]])}
    else:
        wg, wu, wd = (w.to(dtype) for w in (wg, wu, wd))
        wgu = torch.cat([wg, wu], 1)
    assert torch.equal(fused_mlp_plain(x, wgu, None, wd), fused_mlp_plain(x, wg, wu, wd))
