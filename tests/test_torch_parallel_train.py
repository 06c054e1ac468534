"""Data, tensor, sequence and fully sharded parallel training in the port
(parallel/mesh.py, train/step.py, models/lm/llama.py) on gloo CPU ranks,
against the single-process port and the JAX package's plain `train_step`
on the same numpy params and global batches (tiny f32 configs).

One spawn of 4 ranks runs: dp 2 x tp 2 with gradient accumulation (A = 2)
and ragged masks (the dp ranks' rows hold different target and end
counts), 2 steps with clipping; fsdp at dp 2 x tp 2, 2 steps; dp 1 x tp 2
x sp 2; dp 4 with the sigma head (each rank's noise is the single
process's draw for its rows); fsdp at dp 1 x tp 2 x sp 2 (one dp rank: no
dp gathers), 2 steps. One spawn of 8 ranks runs the 3-D cases:
dp 2 x tp 2 x sp 2, and dp 2 x pp 2 x tp 2 through the 1F1B schedule.

Tolerances (f32): against the single-process port, losses rtol 1e-5 and
params rtol/atol 2e-5 (tests/test_train_step.py:160-164), gradients rtol
1e-5 / atol 1e-7 (sums in another order). Against JAX, losses rtol 1e-5,
params rtol 1e-4 / atol 1e-2 * lr: an AdamW step is about
lr * g / (|g| + eps), so a gradient within rounding of 0 that differs in
its last digits between the frameworks moves its weight by a share of lr
(tests/test_torch_train_step.py).
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
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.data import collate
from kalle_tpu_torch.parallel.dryrun import spawn

LR = 1e-3
KW = dict(lr=LR, warmup_steps=1, total_steps=10, log_grad_norm=True, max_grad_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# rows of very different lengths, and in B3 a loss-neutral padding row: the
# dp halves hold different target and end counts
B1 = R.batch(((6, 10), (9, 14), (3, 5), (7, 20)), 1)
B2 = R.batch(((5, 12), (8, 3), (4, 16), (6, 9)), 2)
B3 = collate.pad_batch_rows(R.batch(((4, 9), (7, 11), (5, 18)), 3), 4, 0)


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.LlasaConfig.tiny(head_variant="stableaudio")
    jp = jllasa.init_params(jcfg, jax.random.key(3))
    cfg = config.LlasaConfig.tiny(head_variant="stableaudio")
    sig = config.LlasaConfig.tiny(head_variant="sigma")
    sig_p = bridge.params_to_numpy(R.llasa.init_params(sig, torch.Generator().manual_seed(5),
                                                       "cpu"))
    deep = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=4, pp_microbatches=2, pp_schedule="1f1b"))
    deep_p = bridge.params_to_numpy(R.llasa.init_params(deep, torch.Generator().manual_seed(6),
                                                        "cpu"))
    return jcfg, jp, cfg, jax.tree.map(np.asarray, jp), (sig, sig_p), (deep, deep_p)


def _cases4(models):
    _, _, cfg, p, (sig, sig_p), _ = models
    tc = config.TrainConfig(**KW)
    tc2 = dataclasses.replace(tc, gradient_accumulation_steps=2)
    accum = [collate.stack_microbatches([B1, B3], 0), collate.stack_microbatches([B3, B2], 0)]
    sig_b = R.batch(((6, 10), (9, 14), (3, 5), (7, 20)), 4, dist_dim=8)
    return [
        dict(mesh=dict(dp=2, tp=2), cfg=cfg, tcfg=tc2, params=p, batches=accum),
        dict(mesh=dict(dp=2, tp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1, B2], fsdp=True),
        dict(mesh=dict(dp=1, tp=2, sp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1]),
        dict(mesh=dict(dp=4), cfg=sig, tcfg=tc, params=sig_p, batches=[sig_b], seed=9),
        dict(mesh=dict(dp=1, tp=2, sp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1, B2],
             fsdp=True),
    ]


def _cases8(models):
    _, _, cfg, p, _, (deep, deep_p) = models
    tc = config.TrainConfig(**KW)
    return [dict(mesh=dict(dp=2, tp=2, sp=2), cfg=cfg, tcfg=tc, params=p, batches=[B1, B2]),
            dict(mesh=dict(dp=2, pp=2, tp=2), cfg=deep, tcfg=tc, params=deep_p, batches=[B1],
                 kind="1f1b")]


@pytest.fixture(scope="module")
def four(models):
    cases = _cases4(models)
    return cases, spawn(R.cases, 4, cases, timeout_s=400)


@pytest.fixture(scope="module")
def eight(models):
    cases = _cases8(models)
    return cases, spawn(R.cases, 8, cases, timeout_s=400)


def _jax_run(models, case):
    jcfg, jp, _, _, _, _ = models
    jt = jconfig.TrainConfig(**{**KW, "gradient_accumulation_steps":
                                case["tcfg"].gradient_accumulation_steps})
    tx = joptim.make_optimizer(jt)
    state = jstep.make_train_state(jp, tx)
    losses = []
    for b in case["batches"]:
        state, m = jstep.train_step(state, jcfg, jt, tx, {k: jnp.asarray(v) for k, v in
                                                         b.items()}, jax.random.key(0))
        losses.append(float(m["total_loss"]))
    return losses, bridge.tree_leaves(jax.tree.map(np.asarray, state.params))


def _against_jax(got, models, case):
    losses, params = _jax_run(models, case)
    np.testing.assert_allclose([m["total_loss"] for m in got["metrics"]], losses, rtol=1e-5)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-2 * LR)


def test_dp_tp_accumulation_matches_single_process_and_jax(models, four):
    cases, res = four
    R.against_single(res[0][0], cases[0])
    _against_jax(res[0][0], models, cases[0])
    assert res[0][0]["metrics"][-1]["grad_norm"] > 1.0  # the clip engaged


def test_ragged_masks_across_ranks(four):
    """The dp halves of every microbatch hold different target and end
    counts; every rank still reports the global batch's losses."""
    cases, res = four
    for b in cases[0]["batches"]:
        for k in ("target_mask", "end_mask"):
            halves = b[k][:, :2].sum(axis=(1, 2)), b[k][:, 2:].sum(axis=(1, 2))
            assert (halves[0] != halves[1]).any(), k
    for r in res[1:]:
        assert r[0]["metrics"] == res[0][0]["metrics"]


def test_fsdp_matches_and_holds_a_quarter(models, four):
    """fsdp at dp 2 x tp 2: each layer matrix and both its AdamW moments
    hold 1/(tp*dp) of its elements on every rank."""
    cases, res = four
    R.against_single(res[0][1], cases[1])
    _against_jax(res[0][1], models, cases[1])
    p = bridge.params_from_jax(cases[1]["params"], device="cpu")
    full = [x.numel() for x in bridge.tree_leaves(p)]
    big = {i for i, x in enumerate(bridge.tree_leaves(p)) if x.dim() == 3}
    assert len(big) == 7
    for r in res:
        numel, moments = r[1]["numel"], r[1]["moment_numel"]
        for i in range(len(full)):
            want = full[i] // 4 if i in big else full[i]
            assert numel[i] == want and moments[i] == [want, want], i


def test_fsdp_on_one_dp_rank_matches(models, four):
    """fsdp where dp has one rank (dp 1 x tp 2 x sp 2): the layer matrices
    and their moments hold 1/tp of their elements, and the steps equal the
    single-process port's and JAX's."""
    cases, res = four
    R.against_single(res[0][4], cases[4])
    _against_jax(res[0][4], models, cases[4])
    big = [i for i, n in enumerate(res[0][2]["numel"]) if len(res[0][2]["moment_numel"][i])]
    for r in res:
        assert r[4]["numel"] == r[2]["numel"]  # as without fsdp: tp shards only
        assert r[4]["moment_numel"] == r[2]["moment_numel"]
    assert big


def test_dp_tp_sp_matches_single_process_and_jax(models, four):
    cases, res = four
    R.against_single(res[0][2], cases[2])
    _against_jax(res[0][2], models, cases[2])


def test_sigma_noise_follows_the_rows(four):
    """dp 4, sigma head: every rank draws the global batch's noise and keeps
    its row, so the step equals the single-process one."""
    cases, res = four
    R.against_single(res[0][3], cases[3])
    assert all(r[3]["metrics"] == res[0][3]["metrics"] for r in res)


def test_3d_dp_tp_sp_step(models, eight):
    cases, res = eight
    R.against_single(res[0][0], cases[0])
    _against_jax(res[0][0], models, cases[0])
    assert all(r[0]["metrics"] == res[0][0]["metrics"] for r in res)


def test_3d_dp_pp_tp_1f1b_grads(eight):
    """1F1B over pp 2 with tp 2 inside each stage and dp 2 outside: the
    loss, metrics and (unclipped) gradients of the plain step."""
    cases, res = eight
    case = dict(cases[1], tcfg=dataclasses.replace(cases[1]["tcfg"], max_grad_norm=None))
    R.against_single({"metrics": res[0][1]["metrics"], "grads": res[0][1]["grads"]}, case)
    assert {r[1]["stages"] for r in res} == {2}
    assert max(r[1]["max_live"] for r in res) <= 2
