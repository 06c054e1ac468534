"""Voice-prompted generation: the port's greedy `generate` with an audio
prompt (`prompt_latents`, with and without a `prompt_latents_mask` that
holds zeros) and with a per-frame `embed_bias`, against the JAX `generate`
frame by frame (rtol 1e-4 / atol 1e-5, as tests/test_torch_generate.py),
f32 and int8 weights, n_frames and the end-KL trace included."""
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

MAX_FRAMES = 6
TL = 4  # prompt frames


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
    lat = rng.normal(size=(3, TL, jcfg.latent_dim)).astype(np.float32)
    lat_mask = np.ones((3, TL), np.int32)
    lat_mask[0, :1] = 0  # a left-padded prompt
    lat_mask[2, 2] = 0  # a hole inside one: positions follow the JAX sum
    bias = (0.1 * rng.normal(size=(3, jcfg.llama.hidden_size))).astype(np.float32)
    return jcfg, jp, ids, mask, dict(prompt_latents=lat, prompt_latents_mask=lat_mask,
                                     embed_bias=bias)


CASES = {
    "latents": ("prompt_latents",),
    "latents_mask": ("prompt_latents", "prompt_latents_mask"),
    "bias": ("embed_bias",),
    "latents_bias": ("prompt_latents", "embed_bias"),
}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_prompted_generate_matches_jax(setup, case, quant):
    jcfg, jp, ids, mask, extra = setup
    kw = {k: extra[k] for k in CASES[case]}
    if quant:
        jp = jquantize(jp)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ref = jgenerate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(1),
                    max_frames=MAX_FRAMES, greedy=True,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got = generate(tp, config.LlasaConfig.tiny(), torch.tensor(ids), torch.tensor(mask),
                   max_frames=MAX_FRAMES, greedy=True,
                   **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(ref.n_frames))
    assert got.n_frames.tolist() == [MAX_FRAMES - 1] * 3
    for name in ("means", "samples", "log_scales", "end_kl"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_prompt_changes_the_frames(setup):
    """The prompt and the bias reach the output (a guard on the parity test:
    equal to JAX and equal to the unprompted run would prove nothing)."""
    jcfg, jp, ids, mask, extra = setup
    tp = quantize_llama_params(bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                      device="cpu"))
    cfg = config.LlasaConfig.tiny()

    def means(**kw):
        return generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), max_frames=3,
                        greedy=True, **{k: torch.tensor(v) for k, v in kw.items()}).means

    base = means()
    for k in ("prompt_latents", "embed_bias"):
        assert (means(**{k: extra[k]}) - base).abs().max() > 1e-3, k
