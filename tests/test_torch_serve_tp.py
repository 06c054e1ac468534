"""Tensor- and data-parallel serving in the port (infer/serve_loop.py's
`ContinuousBatcher(mesh=)`, `state_pspecs` / `shard_state`, and
`generate(mesh=)`) on 4 gloo CPU ranks at dp 2 x tp 2 (one spawn),
counterparts of tests/test_serve_tp.py:36, 51, 78, 94 and
tests/test_generate.py:99-129:

  * the sharded batcher (rows over dp, KV heads over tp) reproduces the
    single-process batcher in f32, with an int8 KV cache, with int8 and
    int4 weights, in the fused decode layout fused after sharding, and
    sampling (each rank draws the whole batch's noise); the f32, int8-KV,
    int8- and int4-weight and fused batchers and `generate` also reproduce
    the JAX package's single-device ones on the same numpy params
    (quantized by each package's own `quantize_llama_params`);
  * shard_state prunes its specs to the mesh's axes, as JAX's does.
Frame counts and steps waited exactly; frames at rtol 2e-3 / atol 2e-4,
as in tests/test_serve_tp.py (the port against itself agrees to f32
rounding of the tp sums).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from kalle_tpu.core.config import LlamaConfig as JLlamaConfig
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.infer import serve_loop as jserve
from kalle_tpu.infer.generate import generate as jgenerate
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops.quant import fuse_decode_params as jfuse
from kalle_tpu.ops.quant import quantize_llama_params as jquantize
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.infer import serve_loop
from kalle_tpu_torch.parallel.dryrun import spawn

MAXF = 6
TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(kv="bfloat16"):
    kw = dict(latent_dim=8, audio_proj_dim=64, head_variant="stableaudio",
              end_kl_threshold=-1.0)
    return (JLlasaConfig(llama=dataclasses.replace(JLlamaConfig.tiny(vocab_size=300),
                                                   kv_cache_dtype=kv), **kw),
            LlasaConfig(llama=dataclasses.replace(LlamaConfig.tiny(vocab_size=300),
                                                  kv_cache_dtype=kv), **kw))


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _cfgs()
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    p = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, (n,)).astype(np.int32) for n in (5, 11, 7)]
    ids = rng.integers(1, 300, (2, 8)).astype(np.int64)
    mask = np.ones((2, 8), np.int64)
    mesh = dict(dp=2, tp=2)
    base = dict(mesh=mesh, cfg=cfg, params=p, prompts=prompts, max_frames=MAXF,
                kind="batcher")
    cases = [
        base,
        dict(base, cfg=_cfgs("int8")[1], prompts=prompts[:2]),
        dict(base, bits=8),
        dict(base, bits=4),
        dict(base, bits=8, fused=True),
        dict(base, greedy=False),
        dict(base, kind="generate", prompts=(ids, mask)),
    ]
    return (jcfg, jp), cases, spawn(R.cases, 4, cases, timeout_s=400)


def _same_completions(got, ref):
    assert sorted(got) == sorted(ref)
    for i in ref:
        assert got[i][1:] == ref[i][1:]  # n_frames, steps waited
        np.testing.assert_allclose(got[i][0], ref[i][0], **TOL, err_msg=str(i))


@pytest.mark.parametrize("i", range(6), ids=["f32", "int8_kv", "int8_w", "int4_w",
                                             "int8_fused", "sampled"])
def test_dp_tp_batcher_matches_single_process(run, i):
    _, cases, res = run
    ref = R.run_serve(cases[i], None)["completions"]
    _same_completions(res[0][i]["completions"], ref)
    assert all(not r[i]["completions"] for r in res[1:])  # completions from the main process


def _jax_completions(jp, jcfg, prompts):
    cb = jserve.ContinuousBatcher(jp, jcfg, batch_size=2, max_frames=MAXF,
                                  prompt_buckets=(8, 16), greedy=True)
    return {c.index: (np.asarray(c.means, np.float32), c.n_frames, c.steps_waited)
            for c in cb.run(prompts)}


def test_f32_batcher_matches_jax(run):
    (jcfg, jp), cases, res = run
    _same_completions(res[0][0]["completions"], _jax_completions(jp, jcfg, cases[0]["prompts"]))


@pytest.mark.parametrize("i", range(1, 5), ids=["int8_kv", "int8_w", "int4_w", "int8_fused"])
def test_quantized_batcher_matches_jax(run, i):
    """The dp x tp batcher with an int8 KV cache, int8 / int4 weights and the
    fused int8 layout against the JAX package's single-device batcher on the
    same params, quantized (and fused) by the JAX package's own functions."""
    (jcfg, jp), cases, res = run
    case = cases[i]
    if case["cfg"].llama.kv_cache_dtype == "int8":
        jcfg = _cfgs("int8")[0]
    if case.get("bits"):
        jp = jquantize(jp, bits=case["bits"])
    if case.get("fused"):
        jp = jfuse(jp)
    _same_completions(res[0][i]["completions"], _jax_completions(jp, jcfg, case["prompts"]))


def test_quantized_specs(run):
    """int8: per-column scales follow wq's columns, wo keeps its whole; int4:
    group-wise scales inherit the weight's spec, but the tiny model's single
    group of wo's rows cannot split over tp and stays whole."""
    _, _, res = run
    s8, s4 = res[0][2]["specs"], res[0][3]["specs"]
    assert s8["wq"] == {"q": (None, None, "tp"), "scale": (None, "tp")}
    assert s8["wo"] == {"q": (None, "tp", None), "scale": (None, None)}
    assert s4["wq"] == {"q": (None, None, "tp"), "scale": (None, None, "tp")}
    assert s4["wo"] == {"q": (None, "tp", None), "scale": (None, None, None)}


def test_generate_dp_tp_matches_single_and_jax(run):
    (jcfg, jp), cases, res = run
    ids, mask = cases[6]["prompts"]
    ref = R.run_serve(cases[6], None)
    jref = jgenerate(jp, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                     jax.random.key(1), max_frames=MAXF, end_kl_threshold=-1.0, greedy=True)
    for r in res:  # every rank returns the whole batch
        np.testing.assert_array_equal(r[6]["n_frames"], ref["n_frames"])
        np.testing.assert_array_equal(r[6]["n_frames"], np.asarray(jref.n_frames))
    np.testing.assert_allclose(res[0][6]["means"], ref["means"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res[0][6]["means"], np.asarray(jref.means, np.float32),
                               rtol=2e-4, atol=2e-5)


def _fake_mesh(sizes, coords):
    return types.SimpleNamespace(shape=sizes, coords=lambda: coords)


def test_shard_state_prunes_to_mesh_axes():
    jcfg, cfg = _cfgs()
    state = serve_loop.init_state(cfg, batch_size=2, cache_len=128, max_frames=4, device="cpu")
    jstate = jserve.init_state(jcfg, batch_size=2, cache_len=128, max_frames=4)
    for f in dataclasses.fields(state):
        want = getattr(jserve.state_pspecs(jstate), f.name)
        got = getattr(serve_loop.state_pspecs(state), f.name)
        assert got == (None if want is None else tuple(want)), f.name
    L, B, nkv, hd, C = state.k.shape
    s = serve_loop.shard_state(state, _fake_mesh({"dp": 2}, {"dp": 1}))
    assert s.k.shape == (L, 1, nkv, hd, C) and s.means.shape == (1, 4, 8)
    s = serve_loop.shard_state(state, _fake_mesh({"dp": 1, "tp": 2}, {"dp": 0, "tp": 1}))
    assert s.k.shape == (L, 2, nkv // 2, hd, C) and s.v.shape == (L, 2, nkv // 2, C, hd)
    assert s.means.shape == (2, 4, 8)  # dp absent: replicated
    _, cfg8 = _cfgs("int8")
    s8 = serve_loop.shard_state(serve_loop.init_state(cfg8, 2, 128, 4, device="cpu"),
                                _fake_mesh({"dp": 2, "tp": 2}, {"dp": 0, "tp": 1}))
    assert s8.k_scale.shape == (L, 1, nkv // 2, 1, C)
