"""The port's ContinuousBatcher against the JAX package's, greedy, on the
tiny config and the three prompts of tests/test_serve_loop.py:17-26 — the
JAX batcher's XLA path and its decode-kernel branch in interpret mode
(decode_attention_min_batch=1, decode_attention_interpret=True), the
int8-KV batcher, refill of freed rows, per-row early stop, the sigma head
and streamed chunks. Tolerance rtol 2e-3 / atol 2e-4, as there; frame
counts and steps waited exactly."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.infer.serve_loop import ContinuousBatcher as JBatcher
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
from kalle_tpu_torch.ops.quant import fuse_decode_params

MAXF = 6
TOL = dict(rtol=2e-3, atol=2e-4)
KW = dict(batch_size=2, max_frames=MAXF, prompt_buckets=(8, 16), greedy=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(head="stableaudio", threshold=-1.0, kv="bfloat16"):
    jcfg = JLlasaConfig(llama=dataclasses.replace(JLlamaConfig.tiny(vocab_size=300),
                                                  kv_cache_dtype=kv),
                        latent_dim=8, audio_proj_dim=64, head_variant=head,
                        end_kl_threshold=threshold)
    tcfg = LlasaConfig(llama=dataclasses.replace(LlamaConfig.tiny(vocab_size=300),
                                                 kv_cache_dtype=kv),
                       latent_dim=8, audio_proj_dim=64, head_variant=head,
                       end_kl_threshold=threshold)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, (n,)).astype(np.int32) for n in (5, 11, 7)]
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp, prompts


def _by_index(comps):
    return {c.index: c for c in comps}


@pytest.fixture(scope="module")
def jax_xla(setup):
    jcfg, jp, _, _, prompts = setup
    return _by_index(JBatcher(jp, jcfg, **KW).run(prompts))


@pytest.fixture(scope="module")
def jax_kernel(setup):
    jcfg, jp, _, _, prompts = setup
    kcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
        jcfg.llama, decode_attention_min_batch=1, decode_attention_interpret=True))
    return _by_index(JBatcher(jp, kcfg, **KW).run(prompts))


@pytest.fixture(scope="module")
def port(setup):
    _, _, tcfg, tp, prompts = setup
    cb = ContinuousBatcher(tp, tcfg, device="cpu", **KW)
    return cb, _by_index(cb.run(prompts))


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for i in ref:
        assert got[i].n_frames == ref[i].n_frames
        assert got[i].steps_waited == ref[i].steps_waited
        for name in ("means", "log_scales", "samples"):
            np.testing.assert_allclose(getattr(got[i], name), getattr(ref[i], name),
                                       err_msg=f"request {i} {name}", **TOL)


def test_matches_jax_xla_path(port, jax_xla):
    _assert_same(port[1], jax_xla)


def test_matches_jax_kernel_branch(port, jax_kernel):
    _assert_same(port[1], jax_kernel)


def test_refills_freed_rows(port):
    """Three prompts on two rows: the third is admitted once a row frees
    and still completes in full."""
    cb, comps = port
    assert comps[2].steps_waited <= MAXF
    assert cb.step_count >= 2 * MAXF
    assert all(c.n_frames == MAXF - 1 for c in comps.values())
    assert not bool(cb.state.active.any())


def test_matches_single_request_generate(setup, port):
    """Each completion is the port's own single-request greedy decode."""
    _, _, tcfg, tp, prompts = setup
    for i, ids in enumerate(prompts):
        res = generate(tp, tcfg, torch.tensor(ids[None]), torch.ones((1, len(ids))),
                       max_frames=MAXF, greedy=True)
        n = int(res.n_frames[0])
        assert port[1][i].n_frames == n == MAXF - 1
        np.testing.assert_allclose(port[1][i].means, res.means[0, :n].numpy(), **TOL)


def test_int8_kv_matches_jax(setup):
    _, jp, _, tp, prompts = setup
    jcfg, tcfg = _cfgs(kv="int8")
    ref = _by_index(JBatcher(jp, jcfg, **KW).run(prompts))
    cb = ContinuousBatcher(tp, tcfg, device="cpu", **KW)
    assert cb.state.k.dtype == torch.int8 and cb.state.k_scale is not None
    _assert_same(_by_index(cb.run(prompts)), ref)


def test_early_stop_per_row_matches_jax(setup):
    """A huge threshold stops every row once min_frames are out, each row
    on its own."""
    _, jp, _, tp, prompts = setup
    jcfg, tcfg = _cfgs(threshold=1e9)
    ref = _by_index(JBatcher(jp, jcfg, **KW).run(prompts[:2]))
    got = _by_index(ContinuousBatcher(tp, tcfg, device="cpu", **KW).run(prompts[:2]))
    _assert_same(got, ref)
    assert all(c.n_frames == tcfg.min_frames for c in got.values())


def test_sigma_head_matches_jax(setup):
    """The flagship's head: mean only, sigma fixed; it never stops early at
    the default threshold, so every row runs to max_frames."""
    _, _, _, _, prompts = setup
    jcfg, tcfg = _cfgs(head="sigma", threshold=0.5)
    jp = jllasa.init_params(jcfg, jax.random.key(2))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ref = _by_index(JBatcher(jp, jcfg, **KW).run(prompts))
    got = _by_index(ContinuousBatcher(tp, tcfg, device="cpu", **KW).run(prompts))
    _assert_same(got, ref)
    assert all(c.n_frames == MAXF - 1 for c in got.values())


def test_serve_chunks_match_run(setup, port):
    """serve(chunk_frames=2) streams each request's frames in pieces that,
    joined, are run()'s completion exactly; the first chunk of a request
    comes before its completion."""
    _, _, tcfg, tp, prompts = setup
    cb = ContinuousBatcher(tp, tcfg, device="cpu", **KW)
    chunks, first_chunk, done_at = {}, {}, {}
    for t, (ev, p) in enumerate(cb.serve(prompts, chunk_frames=2)):
        if ev == "chunk":
            chunks.setdefault(p.index, []).append(p)
            first_chunk.setdefault(p.index, t)
        else:
            done_at[p.index] = t
    assert sorted(done_at) == [0, 1, 2]
    for i, ref in port[1].items():
        got = chunks[i]
        assert [c.start_frame for c in got] == list(np.cumsum([0] + [len(c.means)
                                                                     for c in got[:-1]]))
        assert got[-1].final and not any(c.final for c in got[:-1])
        np.testing.assert_array_equal(np.concatenate([c.means for c in got]), ref.means)
        np.testing.assert_array_equal(np.concatenate([c.samples for c in got]), ref.samples)
        assert first_chunk[i] < done_at[i]


def test_serve_open_loop_arrivals(setup):
    """A request that arrives later is admitted only once its time comes
    (fake clock and sleep), and all complete."""
    _, _, tcfg, tp, prompts = setup
    now = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        now[0] += s

    cb = ContinuousBatcher(tp, tcfg, device="cpu", **KW)
    events = list(cb.serve(prompts[:1], arrivals=[5.0], clock=lambda: now[0], sleep=sleep))
    assert slept == [5.0]
    assert [ev for ev, _ in events] == ["done"] and events[0][1].n_frames == MAXF - 1


def test_sampling_is_seeded(setup):
    """Non-greedy decoding draws from the batcher's generator: the same
    seed gives the same frames, another seed others."""
    _, _, tcfg, tp, prompts = setup
    kw = dict(KW, greedy=False)
    a, b, c = (_by_index(ContinuousBatcher(tp, tcfg, seed=s, device="cpu", **kw)
                         .run(prompts[:2])) for s in (3, 3, 4))
    np.testing.assert_array_equal(a[0].samples, b[0].samples)
    assert not np.allclose(a[0].samples, c[0].samples)
    np.testing.assert_array_equal(a[0].means[0], c[0].means[0])  # the first mean is not sampled


def test_what_waits_raises(setup):
    _, _, tcfg, tp, prompts = setup
    # a mesh serves (tests/test_torch_serve_tp.py); its dp must divide the batch
    dp2 = types.SimpleNamespace(size=lambda axis: 2 if axis == "dp" else 1,
                                rank=lambda axis: 0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="dp=2"):
        ContinuousBatcher(tp, tcfg, mesh=dp2, device="cpu", **dict(KW, batch_size=3))
    # the fused decode layout no longer waits: it serves (tests/test_torch_quant_fused.py)
    ContinuousBatcher(fuse_decode_params(tp), tcfg, device="cpu", **KW)
    with pytest.raises(ValueError):
        ContinuousBatcher(tp, tcfg, device="cpu", **KW).run([np.ones(17, np.int32)])
