"""The port's mel-VAE against the JAX package's, f32 on the CPU at
`MelVAEConfig.tiny()`, within 1e-4 of max |ref|: extract_latents, both
flow directions and reverse(forward(z)) = z, inference_from_latents and
inference_from_mean_std with JAX's draws injected, the training forward
(with the encoder frozen and a latent mask, the mask's uniforms injected),
the import of an in-code random torch state dict (weight norm folded),
and the codec facade (`Codec("melvae")` with `flow_reverse`, `Codec.load`
from an h-config and a g_* checkpoint)."""
import itertools
import json
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import melvae as jmel
from kalle_tpu_torch import bridge
from kalle_tpu_torch.infer.pipeline import Codec
from kalle_tpu_torch.models.codecs import melvae

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref,
                               atol=TOL * max(1.0, np.abs(ref).max()), rtol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _perturbed(tree, rng, path=""):
    """Nonzero snake params and flow posts (a fresh init has them 0: the
    flow would be the identity)."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, rng, f"{path}/{i}") for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if path.endswith(("alpha", "beta")) or "/post/" in path and path.startswith("/flows"):
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def params():
    """The port's init (JAX's eager init is slow on the CPU), perturbed, as
    numpy for JAX and as torch tensors."""
    cfg = melvae.MelVAEConfig.tiny()
    jcfg = jmel.MelVAEConfig.tiny()
    tree = bridge.params_to_numpy(melvae.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"))
    jp = _perturbed(tree, np.random.default_rng(0))
    return jcfg, jp, cfg, bridge.params_from_jax(jp, device="cpu")


def test_init_tree_matches_jax(params):
    jcfg, _, cfg, _ = params
    tp = melvae.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda k: jmel.init_params(jcfg, k), jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == \
        {k: tuple(v.shape) for k, v in _flat(ref).items()}
    assert all(float(f["post"]["w"].abs().max()) == 0 for f in tp["flows"])


@pytest.mark.parametrize("t", [64, 72])
def test_extract_latents(params, t):
    jcfg, jp, cfg, tp = params
    wav = (0.5 * np.random.default_rng(t).normal(size=(2, 1, t))).astype(np.float32)
    got = melvae.extract_latents(tp, cfg, torch.from_numpy(wav))
    assert tuple(got.shape) == (2, 2 * cfg.latent_dim, t // cfg.hop)
    _close(got, jmel.extract_latents(jp, jcfg, jnp.asarray(wav)))


def test_flow_both_directions(params):
    jcfg, jp, cfg, tp = params
    z = np.random.default_rng(1).normal(size=(2, cfg.latent_dim, 11)).astype(np.float32)
    tz = torch.from_numpy(z)
    fwd = melvae.flow(tp, cfg, tz)
    rev = melvae.flow(tp, cfg, tz, reverse=True)
    _close(fwd, jmel.flow(jp, jcfg, jnp.asarray(z)))
    _close(rev, jmel.flow(jp, jcfg, jnp.asarray(z), reverse=True))
    assert float((fwd - tz).abs().max()) > 1e-2  # the perturbed flow is not the identity
    _close(melvae.flow(tp, cfg, fwd, reverse=True), z)


@pytest.mark.parametrize("do_sample", [True, False])
def test_inference_from_latents(params, do_sample):
    jcfg, jp, cfg, tp = params
    d = cfg.latent_dim
    x = (0.5 * np.random.default_rng(2).normal(size=(2, 2 * d if do_sample else d, 6))
         ).astype(np.float32)
    key = jax.random.key(3)
    ref = jmel.inference_from_latents(jp, jcfg, jnp.asarray(x), key, do_sample=do_sample)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 6, d))))
    got = melvae.inference_from_latents(tp, cfg, torch.from_numpy(x), do_sample=do_sample,
                                        noise=noise if do_sample else None)
    assert tuple(got.shape) == (2, 1, 6 * cfg.hop)
    _close(got, ref)
    if do_sample:  # the generator's own draw: another sample, same shape, finite
        g = melvae.inference_from_latents(tp, cfg, torch.from_numpy(x),
                                          torch.Generator().manual_seed(0))
        assert g.shape == got.shape and torch.isfinite(g).all()


def test_inference_from_mean_std(params):
    jcfg, jp, cfg, tp = params
    rng = np.random.default_rng(4)
    m = rng.normal(size=(1, cfg.latent_dim, 5)).astype(np.float32)
    logs = (0.2 * rng.normal(size=m.shape) - 1).astype(np.float32)
    key = jax.random.key(5)
    ref = jmel.inference_from_mean_std(jp, jcfg, jnp.asarray(m), jnp.asarray(logs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1, 5, cfg.latent_dim))))
    got = melvae.inference_from_mean_std(tp, cfg, torch.from_numpy(m), torch.from_numpy(logs),
                                         noise=noise)
    _close(got, ref)


@pytest.mark.parametrize("freeze,ratio", [(False, 0.0), (True, 0.5)])
def test_training_forward(params, freeze, ratio):
    """JAX's jitted forward takes the defaults only; the other case runs
    its unjitted function."""
    jcfg, jp, cfg, tp = params
    wav = (0.5 * np.random.default_rng(6).normal(size=(2, 1, 64))).astype(np.float32)
    key = jax.random.key(7)
    shape = (2, 64 // cfg.hop, cfg.latent_dim)
    if ratio:
        ref = jmel.forward.__wrapped__(jp, jcfg, jnp.asarray(wav), key, freeze_encoder=freeze,
                                       latent_mask_ratio=ratio)
    else:
        ref = jmel.forward(jp, jcfg, jnp.asarray(wav), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, shape)))
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 1), shape)))
    tpg = bridge.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    y, (z_p, m_q, logs_q) = melvae.forward(tpg, cfg, torch.from_numpy(wav),
                                           freeze_encoder=freeze, latent_mask_ratio=ratio,
                                           noise=noise, mask_uniform=u)
    _close(y, ref[0])
    for g, r in zip((z_p, m_q, logs_q), ref[1]):
        _close(g, r)
    (y.square().mean() + z_p.square().mean()).backward()
    enc_grad = tpg["encoder"]["pre"]["w"].grad
    assert (enc_grad is None or float(enc_grad.abs().max()) == 0) == freeze
    assert float(tpg["decoder"]["conv_post"]["w"].grad.abs().max()) > 0


def _state_dict(cfg, rng):
    """A random BigVGANFlowVAE state dict for `cfg`, cycling the three ways
    a conv's weight is stored."""
    styles = itertools.cycle(["v", "param", "plain"])
    sd = {}
    f = lambda *s: torch.from_numpy((0.3 * rng.normal(size=s)).astype(np.float32))

    def conv(prefix, cout, cin, k, transposed=False):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        style = next(styles)
        if style == "v":
            sd[prefix + ".weight_v"], sd[prefix + ".weight_g"] = f(*shape), f(shape[0], 1, 1)
        elif style == "param":
            sd[prefix + ".parametrizations.weight.original1"] = f(*shape)
            sd[prefix + ".parametrizations.weight.original0"] = f(shape[0], 1, 1)
        else:
            sd[prefix + ".weight"] = f(*shape)
        sd[prefix + ".bias"] = f(cout)

    def act(prefix, c):
        sd[prefix + ".act.alpha"], sd[prefix + ".act.beta"] = f(c), f(c)

    chs, ge = cfg.downsample_channels, "audio_encoder.generator"
    conv(f"{ge}.0.layer", chs[0], cfg.in_channels, cfg.proj_kernel_size)
    for i, fr in enumerate(cfg.downsample_rates):
        conv(f"{ge}.{2 + 3 * i}.layer", chs[i + 1], chs[i], 2 * fr)
        for j in range(cfg.stacks):
            conv(f"{ge}.{3 + 3 * i}.layers.{j}.1", chs[i + 1], chs[i + 1], cfg.stack_kernel_size)
            conv(f"{ge}.{3 + 3 * i}.layers.{j}.3", chs[i + 1], chs[i + 1], cfg.stack_kernel_size)
    nd = len(cfg.downsample_rates)
    conv(f"{ge}.{2 + 3 * nd}.layer", 2 * cfg.latent_dim, chs[-1], cfg.proj_kernel_size)
    half, hid = cfg.latent_dim // 2, cfg.flow_hidden_channels
    for i in range(cfg.n_flows):
        base = f"flow.flows.{2 * i}"
        conv(f"{base}.pre", hid, half, 1)
        for j in range(cfg.flow_n_layers):
            conv(f"{base}.enc.in_layers.{j}", 2 * hid, hid, cfg.flow_kernel_size)
            conv(f"{base}.enc.res_skip_layers.{j}",
                 2 * hid if j < cfg.flow_n_layers - 1 else hid, hid, 1)
        conv(f"{base}.post", half, hid, 1)
    up0 = cfg.upsample_initial_channel
    conv("conv_pre", up0, cfg.latent_dim, 7)
    nk = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        ch = up0 // 2 ** (i + 1)
        conv(f"ups.{i}.0", ch, up0 // 2 ** i, k, transposed=True)
        for j, (kk, dd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            base = f"resblocks.{i * nk + j}"
            for c in range(len(dd)):
                conv(f"{base}.convs1.{c}", ch, ch, kk)
                conv(f"{base}.convs2.{c}", ch, ch, kk)
            for a in range(2 * len(dd)):
                act(f"{base}.activations.{a}", ch)
    act("activation_post", ch)
    conv("conv_post", 1, ch, 7)
    return sd


def test_state_dict_import_and_codec(tmp_path):
    # an h-config names only some fields (`from_h`): the rest take their
    # defaults, so this config keeps them
    cfg = replace(melvae.MelVAEConfig.tiny(), stacks=6, n_flows=4, flow_n_layers=4)
    sd = _state_dict(cfg, np.random.default_rng(8))
    ref = _flat(jmel.params_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg))
    got = _flat(melvae.params_from_state_dict(sd, cfg, device="cpu"))
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r, atol=1e-6, rtol=1e-6, err_msg=k)

    # the loader: an h-config JSON + a g_* checkpoint holding {'generator': sd}
    h = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else
             list(v) if isinstance(v, tuple) else v) for k, v in asdict(cfg).items()}
    h["sampling_rate"] = h.pop("sample_rate")
    hc, ckpt = tmp_path / "config.json", str(tmp_path / "g_00000001")
    hc.write_text(json.dumps(h))
    torch.save({"generator": sd}, ckpt)
    jcfg, jp = jmel.load_pretrained(str(hc), ckpt)
    codec = Codec.load("melvae", str(hc), ckpt, device="cpu")
    assert asdict(codec.cfg) == asdict(jcfg) == asdict(cfg)

    wav = (0.5 * np.random.default_rng(9).normal(size=(1, 1, 8 * jcfg.hop))).astype(np.float32)
    _close(torch.from_numpy(codec.encode_audio(wav)),
           jmel.extract_latents(jp, jcfg, jnp.asarray(wav)))
    lat = np.random.default_rng(10).normal(size=(2, 5, cfg.latent_dim)).astype(np.float32)
    zt = jnp.asarray(lat.transpose(0, 2, 1))
    for flow_reverse in (False, True):
        z = jmel.flow(jp, jcfg, zt, reverse=True) if flow_reverse else zt
        ref = jmel.inference_from_latents(jp, jcfg, z, jax.random.key(0), do_sample=False)
        _close(torch.from_numpy(codec.decode_latents(lat, flow_reverse=flow_reverse)), ref)
