"""The 1F1B pipeline schedule in the port (parallel/pipeline_1f1b.py through
train/step.py) on 4 gloo CPU ranks (one spawn), against the plain path on a
4-layer tiny f32 model from JAX's init (counterpart of
tests/test_pipeline_1f1b.py):

  * the loss, metrics and gradients of the 1F1B loss at dp 2 x pp 2 and pp
    2 x tp 2 (M = 2) equal the plain step's (single-process port: losses
    rtol 1e-5, gradients rtol 1e-5 / atol 1e-7; JAX's plain `loss_fn` and
    its gradients: losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-6);
  * a whole train_step through 1F1B at dp 2 x pp 2 matches the
    single-process step (params rtol / atol 2e-5) and the GPipe step's
    metrics;
  * no rank holds more than S stage inputs at once, at M = 2S and 4S, for
    S = 2 and 4.
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
from kalle_tpu.train import step as jstep
from kalle_tpu_torch.core import config
from kalle_tpu_torch.parallel.dryrun import spawn

KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B4 = R.batch(((6, 10), (9, 14), (3, 5), (7, 20)), 21)
B16 = R.batch(tuple((3 + i % 7, 4 + (5 * i) % 17) for i in range(16)), 22)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _deep(mod, m=2, schedule="1f1b"):
    cfg = mod.LlasaConfig.tiny(head_variant="stableaudio")
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=4, pp_microbatches=m, pp_schedule=schedule))


@pytest.fixture(scope="module")
def run():
    jcfg = _deep(jconfig)
    jp = jllasa.init_params(jcfg, jax.random.key(2))
    p = jax.tree.map(np.asarray, jp)
    tc = config.TrainConfig(**KW)
    cases = [
        dict(mesh=dict(dp=2, pp=2), cfg=_deep(config), tcfg=tc, params=p, batches=[B4],
             kind="1f1b"),
        dict(mesh=dict(dp=1, pp=2, tp=2), cfg=_deep(config), tcfg=tc, params=p, batches=[B4],
             kind="1f1b"),
        dict(mesh=dict(dp=2, pp=2), cfg=_deep(config), tcfg=tc, params=p, batches=[B4, B4]),
        dict(mesh=dict(dp=2, pp=2), cfg=_deep(config, schedule="gpipe"), tcfg=tc, params=p,
             batches=[B4, B4]),
    ]
    # live stage inputs: M = 2S and 4S microbatches of one row each
    for s in (2, 4):
        for m in (2 * s, 4 * s):
            rows = {k: v[:m * (4 // s)] for k, v in B16.items()}  # one row a microbatch
            cases.append(dict(mesh=dict(dp=4 // s, pp=s), cfg=_deep(config, m=m), tcfg=tc,
                              params=p, batches=[rows], kind="1f1b"))
    return (jcfg, jp), cases, spawn(R.cases, 4, cases, timeout_s=400)


@pytest.mark.parametrize("i", [0, 1], ids=["dp2xpp2", "pp2xtp2"])
def test_1f1b_grads_and_metrics_match_plain(run, i):
    (jcfg, jp), cases, res = run
    got = res[0][i]
    R.against_single(got, cases[i])
    jt = jconfig.TrainConfig(**KW)
    batch = {k: jnp.asarray(v) for k, v in cases[i]["batches"][0].items()}
    (loss, jm), grads = jax.value_and_grad(
        lambda q: jstep.loss_fn(q, jcfg, jt, batch, jax.random.key(0)), has_aux=True)(jp)
    for k in ("total_loss", "audio_loss", "end_loss"):
        np.testing.assert_allclose(got["metrics"][0][k], float(jm[k]), rtol=1e-5, err_msg=k)
    for a, b in zip(got["grads"], R.bridge.tree_leaves(jax.tree.map(np.asarray, grads))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert all(r[i]["metrics"] == got["metrics"] for r in res)


def test_1f1b_train_step_matches_plain_and_gpipe(run):
    _, cases, res = run
    R.against_single(res[0][2], cases[2])
    for a, b in zip(res[0][2]["metrics"], res[0][3]["metrics"]):
        for k in ("total_loss", "audio_loss", "end_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("i", [4, 5, 6, 7], ids=["S2_M4", "S2_M8", "S4_M8", "S4_M16"])
def test_live_stage_inputs_bounded_by_stages(run, i):
    _, cases, res = run
    s = cases[i]["mesh"]["pp"]
    assert cases[i]["cfg"].llama.pp_microbatches in (2 * s, 4 * s)
    lives = [r[i]["max_live"] for r in res]
    assert max(lives) <= s
    assert max(lives) == s  # stage 0 fills its ring
    R.against_single(res[0][i], dict(cases[i], kind="train"))
