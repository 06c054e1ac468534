"""The slice end to end on the tiny config: the port's `generate` against
the JAX `generate` (rtol 1e-4 / atol 1e-5 frame by frame, as
tests/test_generate.py:60,78), including left-padded rows, int8 weights,
n_frames and the early-stop arm (exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.infer.generate import generate as jgenerate
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops.quant import quantize_llama_params as jquantize
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.infer.generate import generate
from kalle_tpu_torch.ops.quant import quantize_llama_params

MAX_FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.LlasaConfig.tiny()
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, :2] = 0  # left pads
    mask[2, :5] = 0
    ids[mask == 0] = 0
    return jcfg, jp, config.LlasaConfig.tiny(), ids, mask


def _run_both(setup, quant=False, threshold=None):
    jcfg, jp, tcfg, ids, mask = setup
    if quant:
        jp = jquantize(jp)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ref = jgenerate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(1),
                    max_frames=MAX_FRAMES, end_kl_threshold=threshold, greedy=True)
    got = generate(tp, tcfg, torch.tensor(ids), torch.tensor(mask),
                   max_frames=MAX_FRAMES, end_kl_threshold=threshold, greedy=True)
    return ref, got


@pytest.mark.parametrize("quant", [False, True])
def test_greedy_generate_matches_jax(setup, quant):
    ref, got = _run_both(setup, quant=quant)
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    assert got.n_frames.tolist() == [MAX_FRAMES - 1] * 3  # sigma never stops at 0.5
    for name in ("means", "samples", "log_scales", "end_kl"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_early_stop_arm_matches_jax(setup):
    """end_kl_threshold 2.0 sits above the sigma head's KL floor (~1.21):
    every row stops once min_frames are out; n_frames must agree exactly."""
    ref, got = _run_both(setup, threshold=2.0)
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    assert (got.n_frames < MAX_FRAMES - 1).all()
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means),
                               rtol=1e-4, atol=1e-5)


def test_sampling_is_seeded(setup):
    """Non-greedy decoding draws its noise from the caller's generator."""
    jcfg, jp, tcfg, ids, mask = setup
    tp = quantize_llama_params(bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                      device="cpu"))
    runs = [generate(tp, tcfg, torch.tensor(ids), torch.tensor(mask),
                     torch.Generator().manual_seed(s), max_frames=4).samples
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
