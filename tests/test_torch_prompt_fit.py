"""The port's test-time prompt fitting (kalle_tpu_torch/infer/optim.py)
and `llasa.sample_gaussian` against the JAX package, on the CPU at the
tiny config.

The two packages draw the prompt latents' noise from different
generators, so the prompt's log-scales are -30: exp(-30) * N(0, 1) is far
below an f32 ulp of the means, and the drawn latents equal the means on
both sides. The loss is held at 1e-5; params after AdamW steps at rtol
1e-4 / atol 1e-2 * lr (an update is about lr * g / (|g| + eps), so a
gradient within a few eps of zero moves its weight by a share of lr).
`sample_gaussian` draws with torch's generator, so its std structure
(one random std a row, N(0, 1) * std / 0.8) is checked by moments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.infer import optim as joptim
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.infer import optim
from kalle_tpu_torch.models.lm import llasa

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(head):
    jcfg = jconfig.LlasaConfig.tiny(head_variant=head)
    tcfg = config.LlasaConfig.tiny(head_variant=head)
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 300, (1, 7)).astype(np.int32)
    mean = rng.normal(size=(1, 11, 8)).astype(np.float32)
    logs = np.full_like(mean, -30.0)
    return jcfg, jp, tcfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), (
        ids, mean, logs)


def _torch_inputs(arrays):
    ids, mean, logs = arrays
    return torch.from_numpy(ids).long(), torch.from_numpy(mean), torch.from_numpy(logs)


@pytest.mark.parametrize("head", ["sigma", "stableaudio"])
def test_prompt_kl_loss_matches_jax(head):
    jcfg, jp, tcfg, tp, arrays = _setup(head)
    ids, mean, logs = _torch_inputs(arrays)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(2))
    got = optim.prompt_kl_loss(tp, tcfg, ids, mean, logs, noise)
    ref = joptim.prompt_kl_loss(jp, jcfg, *map(jnp.asarray, arrays), jax.random.key(3))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("threshold", [None, 1e9])
def test_prompt_fit_matches_jax(threshold):
    """3 AdamW steps (warmup 1, cosine over 10), and with a threshold above
    any loss: the first step runs (the loss starts at inf), then it stops,
    and that step's lr is 0. The sigma head: its KL takes the prompt's
    means with the fixed sigma (the stableaudio head's KL against a std of
    exp(-30) is ~1e26, and Adam's sign-like first steps then follow the
    rounding of gradients near 0)."""
    jcfg, jp, tcfg, tp, arrays = _setup("sigma")
    kw = dict(lr=LR, max_steps=3, warmup=1, train_steps=10, loss_threshold=threshold)
    ref_p, ref_loss = joptim.prompt_fit(jp, jcfg, *map(jnp.asarray, arrays),
                                        jax.random.key(4), **kw)
    got_p, got_loss = optim.prompt_fit(tp, tcfg, *_torch_inputs(arrays),
                                       torch.Generator().manual_seed(4), **kw)
    np.testing.assert_allclose(got_loss, float(ref_loss), rtol=1e-5, atol=1e-6)
    ref_leaves = bridge.tree_leaves(jax.tree.map(np.asarray, ref_p))
    moved = 0
    for g, r, before in zip(bridge.tree_leaves(got_p), ref_leaves, bridge.tree_leaves(tp)):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-2 * LR)
        assert not g.requires_grad
        moved += int(not torch.equal(g, before))
    assert (moved > 0) == (threshold is None)  # and the caller's tree did not move
    assert all(not p.requires_grad for p in bridge.tree_leaves(tp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_gaussian_std_structure(dtype):
    std = 0.5
    mean = torch.full((4000, 40, 4), 3.0, dtype=dtype)
    out = llasa.sample_gaussian(torch.Generator().manual_seed(0), mean, std)
    assert out.dtype == dtype and out.shape == mean.shape
    row_std = (out.float() - 3.0).reshape(4000, -1).std(dim=1) / (std / 0.8)
    # each row's std is |N(0, 1)| * std / 0.8: mean sqrt(2 / pi), second moment 1
    assert abs(float(row_std.mean()) - (2 / np.pi) ** 0.5) < 0.03
    assert abs(float((row_std ** 2).mean()) - 1.0) < 0.06
    assert float(row_std.std()) > 0.5  # the std differs from row to row
    again = llasa.sample_gaussian(torch.Generator().manual_seed(0), mean, std)
    assert torch.equal(out, again)
