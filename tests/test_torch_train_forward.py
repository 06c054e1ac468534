"""The port's training forward against the JAX package on the tiny configs
(CPU, f32), weights carried by bridge.params_from_jax:

  * llama.forward through the mask path (`mha`) and through the flash path
    (the plain versions of K5-K7) against JAX's XLA path and its Pallas
    flash kernel in interpret mode, on every row (right padding, a
    left-padded row) at atol 2e-5 / rtol 2e-4 (tests/test_flash_attention.py:24);
  * llasa.forward losses and parameter grads for the sigma (injected
    latent noise), stableaudio and melvae heads, through both attention
    paths, against jax.value_and_grad at rtol 2e-3 / atol 2e-5
    (tests/test_flash_attention.py:131);
  * remat "full" and "dots" give the grads of no remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.models.lm import llama as jllama
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.models.lm import llama, llasa

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
HEADS = ("sigma", "stableaudio", "melvae")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _batch(head_out_dim, latent_dim, b=3, t=128, seed=4):
    """A packed batch: row 0 fills 100 positions, row 1 60, row 2 is left
    padded (its first 16 positions are pad)."""
    rng = np.random.default_rng(seed)
    batch = {
        "input_ids": rng.integers(0, 300, (b, t)).astype(np.int32),
        "audio_latents": rng.normal(size=(b, t, latent_dim)).astype(np.float32),
        # positive, so the 2d heads can read the second half as a scale
        "distribute_labels": (np.abs(rng.normal(size=(b, t, head_out_dim))) + 0.5
                              ).astype(np.float32),
    }
    ids, audio, tgt, end = (np.zeros((b, t), bool) for _ in range(4))
    for i, (s0, s, e) in enumerate(((0, 20, 100), (0, 12, 60), (16, 30, 90))):
        ids[i, s0:s] = True
        audio[i, s:e] = True
        tgt[i, s - 1:e - 1] = True
        end[i, e - 1] = True
    batch.update(ids_mask=ids, audio_mask=audio, target_mask=tgt, end_mask=end)
    noise = rng.normal(size=(b, t, latent_dim)).astype(np.float32)
    return batch, noise


@pytest.fixture(scope="module")
def backbone():
    """JAX llama.forward on the tiny config through the XLA path and the
    interpret-mode flash kernel (one compile each)."""
    cfg = jconfig.LlamaConfig.tiny()
    params = jllama.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(3, 128, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((3, 128), np.int32)
    mask[0, 100:] = 0
    mask[2, :24] = 0  # left padded: its first queries see no valid key
    out = {fl: np.asarray(jllama.forward(params, cfg, jnp.asarray(emb), jnp.asarray(mask),
                                         use_flash=fl)) for fl in (False, True)}
    return bridge.params_from_jax(_np_tree(params), device="cpu"), emb, mask, out


@pytest.mark.parametrize("use_flash", [False, True], ids=["mask_path", "flash_path"])
def test_llama_forward_matches_jax(backbone, use_flash):
    params, emb, mask, ref = backbone
    got = llama.forward(params, config.LlamaConfig.tiny(), torch.from_numpy(emb),
                        torch.from_numpy(mask), use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), ref[use_flash], **FWD_TOL)


def test_flash_route_needs_a_block_multiple(backbone):
    """t % 128 != 0 falls back to the mask path, as in JAX."""
    params, emb, mask, _ = backbone
    cfg = config.LlamaConfig.tiny()
    x, m = torch.from_numpy(emb[:, :96]), torch.from_numpy(mask[:, :96])
    torch.testing.assert_close(llama.forward(params, cfg, x, m, use_flash=True),
                               llama.forward(params, cfg, x, m, use_flash=False))


@pytest.fixture(scope="module")
def heads():
    """Per head variant: JAX params, batch, noise and jax.value_and_grad of
    audio_loss + 0.002 end_loss through the XLA attention path."""
    out = {}
    for hv in HEADS:
        jcfg = jconfig.LlasaConfig.tiny(head_variant=hv)
        jp = jllasa.init_params(jcfg, jax.random.key(1))
        batch, noise = _batch(jcfg.head_out_dim, jcfg.latent_dim)

        def loss(p):
            o = jllasa.forward(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                               latent_noise=jnp.asarray(noise), use_flash=False)
            return o["audio_loss"] + 0.002 * o["end_loss"], (o["audio_loss"], o["end_loss"])

        (_, (audio, end)), grads = jax.value_and_grad(loss, has_aux=True)(jp)
        out[hv] = (jp, batch, noise, float(audio), float(end), _flat(_np_tree(grads)))
    return out


def _port_loss_and_grads(jp, hv, batch, noise, use_flash, **llama_kw):
    cfg = config.LlasaConfig.tiny(head_variant=hv)
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, **llama_kw))
    params = bridge.params_from_jax(_np_tree(jp), device="cpu")
    leaves = bridge.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = llasa.forward(params, cfg, tb, latent_noise=torch.from_numpy(noise),
                        use_flash=use_flash)
    grads = torch.autograd.grad(out["audio_loss"] + 0.002 * out["end_loss"], leaves)
    names = list(_flat(params))
    return out, dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("use_flash", [False, True], ids=["mask_path", "flash_path"])
@pytest.mark.parametrize("hv", HEADS)
def test_llasa_losses_and_grads_match_jax(heads, hv, use_flash):
    jp, batch, noise, audio, end, ref = heads[hv]
    out, grads = _port_loss_and_grads(jp, hv, batch, noise, use_flash)
    np.testing.assert_allclose(out["audio_loss"].item(), audio, rtol=1e-5)
    np.testing.assert_allclose(out["end_loss"].item(), end, rtol=1e-5)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref[name], **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_grads_of_no_remat(heads, policy):
    """torch.utils.checkpoint recomputes the same f32 ops: the grads agree
    to f32 rounding (the recompute may take other kernels' sum orders)."""
    jp, batch, noise, *_ = heads["sigma"]
    _, plain = _port_loss_and_grads(jp, "sigma", batch, noise, True)
    _, remat = _port_loss_and_grads(jp, "sigma", batch, noise, True, remat=True,
                                    remat_policy=policy)
    for name, g in remat.items():
        np.testing.assert_allclose(g, plain[name], rtol=1e-5, atol=1e-7, err_msg=name)


def test_sigma_needs_noise_or_a_generator(heads):
    jp, batch, *_ = heads["sigma"]
    params = bridge.params_from_jax(_np_tree(jp), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="generator or latent_noise"):
        llasa.forward(params, config.LlasaConfig.tiny(), tb)
    out = llasa.forward(params, config.LlasaConfig.tiny(), tb,
                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["audio_loss"])
