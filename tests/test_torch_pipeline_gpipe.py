"""GPipe pipeline parallelism in the port (parallel/pipeline.py through
llama.forward) on 4 gloo CPU ranks (one spawn), against the plain path:
the single-process port and the JAX package's plain `train_step`, on a
4-layer tiny f32 model from JAX's init (counterpart of tests/test_pipeline.py).

  * the forward at pp 4 and at pp 2 x tp 2 (2 microbatches) equals the
    plain forward on every stage (rtol 1e-5 / atol 1e-6: tp sums the
    row-parallel products in another order);
  * train steps at dp 2 x pp 2, pp 2 x tp 2 and at pp 4 with remat match
    the single-process step (tests/torch_parallel_ranks.against_single:
    losses rtol 1e-5, gradients rtol 1e-5 / atol 1e-7, params 2e-5) and
    JAX's plain step (losses rtol 1e-5, params rtol 1e-4 / atol 1e-2 *
    lr, the AdamW rule of tests/test_torch_train_step.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from kalle_tpu.core import config as jconfig
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.train import optim as joptim
from kalle_tpu.train import step as jstep
from kalle_tpu_torch.core import config
from kalle_tpu_torch.parallel.dryrun import spawn

LR = 1e-3
KW = dict(lr=LR, warmup_steps=1, total_steps=10)
B1 = R.batch(((6, 10), (9, 14), (3, 5), (7, 20)), 11)
B2 = R.batch(((5, 12), (8, 3), (4, 16), (6, 9)), 12)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _deep(mod, **llama_kw):
    cfg = mod.LlasaConfig.tiny(head_variant="stableaudio")
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=4, pp_microbatches=2, **llama_kw))


@pytest.fixture(scope="module")
def run():
    jcfg = _deep(jconfig)
    jp = jllasa.init_params(jcfg, jax.random.key(1))
    p = jax.tree.map(np.asarray, jp)
    cfg, tc = _deep(config), config.TrainConfig(**KW)
    cases = [
        dict(mesh=dict(dp=1, pp=4), cfg=cfg, tcfg=tc, params=p, batches=[B1], kind="forward"),
        dict(mesh=dict(dp=1, pp=2, tp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1],
             kind="forward"),
        dict(mesh=dict(dp=2, pp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1, B2]),
        dict(mesh=dict(dp=1, pp=2, tp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1, B2]),
        dict(mesh=dict(dp=1, pp=4), cfg=_deep(config, remat=True), tcfg=tc, params=p,
             batches=[B1]),
    ]
    return (jcfg, jp), cases, spawn(R.cases, 4, cases, timeout_s=400)


def _jax_losses_params(jcfg, jp, batches):
    jt = jconfig.TrainConfig(**KW)
    tx = joptim.make_optimizer(jt)
    state, losses = jstep.make_train_state(jp, tx), []
    for b in batches:
        state, m = jstep.train_step(state, jcfg, jt, tx,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.key(0))
        losses.append(float(m["total_loss"]))
    return losses, R.bridge.tree_leaves(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("i", [0, 1], ids=["pp4", "pp2xtp2"])
def test_forward_matches_plain(run, i):
    _, cases, res = run
    ref = R.run_forward(cases[i], None)["hidden"]
    for r in res:  # every stage returns the whole batch
        np.testing.assert_allclose(r[i]["hidden"], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("i", [2, 3, 4], ids=["dp2xpp2", "pp2xtp2", "pp4_remat"])
def test_train_steps_match_plain_and_jax(run, i):
    (jcfg, jp), cases, res = run
    R.against_single(res[0][i], cases[i])
    losses, params = _jax_losses_params(jcfg, jp, cases[i]["batches"])
    np.testing.assert_allclose([m["total_loss"] for m in res[0][i]["metrics"]], losses,
                               rtol=1e-5)
    for a, b in zip(res[0][i]["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-2 * LR)
    assert all(r[i]["metrics"] == res[0][i]["metrics"] for r in res)
    # each stage holds its L / pp layers (tp: a column block of them)
    wq = R.paths(cases[i]["params"]).index("llama/layers/wq")
    full = cases[i]["params"]["llama"]["layers"]["wq"].size
    mesh = cases[i]["mesh"]
    assert res[0][i]["numel"][wq] == full // (mesh["pp"] * mesh.get("tp", 1))
