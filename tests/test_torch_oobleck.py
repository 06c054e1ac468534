"""The port's Oobleck VAE against the JAX package's, f32 on the CPU, at a
tiny width: encode and decode of the same params (carried over by
`bridge.params_from_jax`) within 1e-4 of max |ref|, and the import of an
in-code random torch state dict (weight_v / weight_g, parametrizations
and plain weights, a nested `pretransform.model.` prefix) against the JAX
importer, through `load_pretrained` from a model_config.json and a .pt or
.safetensors file, and through `Codec.load`."""
import itertools
import json
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import oobleck as joob
from kalle_tpu_torch import bridge
from kalle_tpu_torch.infer.pipeline import Codec
from kalle_tpu_torch.models.codecs import oobleck

TOL = 1e-4
CFG = dict(channels=4, latent_dim=4, encoder_out_dim=8, c_mults=(1, 2), strides=(2, 4))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()), rtol=0)


def _flat(tree, prefix=""):
    """{path: leaf} over a nested dict/list tree (key order ignored)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _snake_perturbed(tree, rng):
    """Nonzero snake params (a fresh init has them all 0)."""
    if isinstance(tree, dict):
        return {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
                if k in ("alpha", "beta") else _snake_perturbed(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snake_perturbed(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def params():
    """The port's init (JAX's eager init is slow on the CPU), snake params
    perturbed, as numpy for JAX and as torch tensors."""
    jcfg, cfg = joob.OobleckConfig(**CFG), oobleck.OobleckConfig(**CFG)
    tree = bridge.params_to_numpy(oobleck.init_params(cfg, torch.Generator().manual_seed(0),
                                                      "cpu"))
    jp = _snake_perturbed(tree, np.random.default_rng(0))
    return jcfg, jp, cfg, bridge.params_from_jax(jp, device="cpu")


def test_init_tree_matches_jax(params):
    jcfg, jp, cfg, tp = params
    ref = jax.eval_shape(lambda k: joob.init_params(jcfg, k), jax.random.key(0))
    shapes = lambda tree: {k: tuple(v.shape) for k, v in _flat(tree).items()}
    assert shapes(tp) == shapes(ref)
    assert "b" not in tp["decoder"]["out_conv"]  # the last conv has no bias


@pytest.mark.parametrize("t", [40, 77])
def test_encode_decode_match_jax(params, t):
    jcfg, jp, cfg, tp = params
    audio = (0.5 * np.random.default_rng(t).normal(size=(2, 2, t))).astype(np.float32)
    ref = joob.encode(jp, jcfg, jnp.asarray(audio))
    got = oobleck.encode(tp, cfg, torch.from_numpy(audio))
    _close(got, ref)
    z = np.array(ref)[:, : cfg.latent_dim]
    refd = joob.decode(jp, jcfg, jnp.asarray(z))
    gotd = oobleck.decode(tp, cfg, torch.from_numpy(z))
    assert tuple(gotd.shape) == (2, 2, z.shape[-1] * cfg.downsampling_ratio)
    _close(gotd, refd)


def _state_dict(cfg, rng):
    """A random AudioAutoencoder state dict for `cfg`, cycling the three
    ways a conv's weight is stored."""
    styles = itertools.cycle(["v", "param", "plain"])
    sd = {}
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))

    def conv(prefix, cout, cin, k, bias=True, transposed=False):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        style = next(styles)
        if style == "v":
            sd[prefix + ".weight_v"], sd[prefix + ".weight_g"] = f(*shape), f(shape[0], 1, 1)
        elif style == "param":
            sd[prefix + ".parametrizations.weight.original1"] = f(*shape)
            sd[prefix + ".parametrizations.weight.original0"] = f(shape[0], 1, 1)
        else:
            sd[prefix + ".weight"] = f(*shape)
        if bias:
            sd[prefix + ".bias"] = f(cout)

    def act(prefix, c):
        sd[prefix + ".alpha"], sd[prefix + ".beta"] = 0.3 * f(c), 0.3 * f(c)

    def res(prefix, c):
        act(prefix + ".layers.0", c)
        conv(prefix + ".layers.1", c, c, 7)
        act(prefix + ".layers.2", c)
        conv(prefix + ".layers.3", c, c, 1)

    cm = (1,) + cfg.c_mults
    ch, n = cfg.channels, len(cfg.c_mults)
    conv("encoder.layers.0", ch * cm[0], cfg.io_channels, 7)
    for i in range(n):
        base = f"encoder.layers.{i + 1}.layers"
        for j in range(3):
            res(f"{base}.{j}", cm[i] * ch)
        act(f"{base}.3", cm[i] * ch)
        conv(f"{base}.4", cm[i + 1] * ch, cm[i] * ch, 2 * cfg.strides[i])
    act(f"encoder.layers.{n + 1}", cm[-1] * ch)
    conv(f"encoder.layers.{n + 2}", cfg.encoder_out_dim, cm[-1] * ch, 3)
    conv("decoder.layers.0", cm[-1] * ch, cfg.latent_dim, 7)
    for i in range(n):
        cin, cout, s = cm[n - i] * ch, cm[n - 1 - i] * ch, cfg.strides[n - 1 - i]
        base = f"decoder.layers.{i + 1}.layers"
        act(f"{base}.0", cin)
        conv(f"{base}.1", cout, cin, 2 * s + s % 2, transposed=True)
        for j in range(3):
            res(f"{base}.{j + 2}", cout)
    act(f"decoder.layers.{n + 1}", cm[0] * ch)
    conv(f"decoder.layers.{n + 2}", cfg.io_channels, cm[0] * ch, 7, bias=False)
    return sd


def _model_config(cfg, nested):
    ae = {"io_channels": cfg.io_channels,
          "encoder": {"config": {"channels": cfg.channels, "latent_dim": cfg.encoder_out_dim,
                                 "c_mults": list(cfg.c_mults), "strides": list(cfg.strides)}},
          "decoder": {"config": {"latent_dim": cfg.latent_dim}}}
    if nested:
        return {"sample_rate": 44100,
                "model": {"pretransform": {"scale": 2.0, "config": ae}}}
    return {"model_type": "autoencoder", "sample_rate": 44100, "model": ae}


@pytest.mark.parametrize("nested,suffix", [(False, ".pt"), (True, ".safetensors")])
def test_state_dict_import_matches_jax(tmp_path, nested, suffix):
    cfg = oobleck.OobleckConfig(**CFG)
    sd = _state_dict(cfg, np.random.default_rng(1))
    ref = joob.params_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    got = oobleck.params_from_state_dict(sd, cfg, device="cpu")
    assert "b" not in got["decoder"]["out_conv"]
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r, atol=1e-6, rtol=1e-6, err_msg=k)

    # the loader: model_config.json + a checkpoint, a nested prefix or not
    mc = tmp_path / "model_config.json"
    mc.write_text(json.dumps(_model_config(cfg, nested)))
    ckpt = str(tmp_path / f"model{suffix}")
    nest = {("pretransform.model." if nested else "") + k: v for k, v in sd.items()}
    if suffix == ".pt":
        torch.save({"state_dict": nest}, ckpt)
    else:
        from safetensors.torch import save_file

        save_file(nest, ckpt)
    jcfg, jp = joob.load_pretrained(str(mc), ckpt)
    lcfg, lp = oobleck.load_pretrained(str(mc), ckpt, device="cpu")
    assert asdict(lcfg) == asdict(jcfg) and lcfg.scale == (2.0 if nested else 1.0)
    codec = Codec.load("stableaudio", str(mc), ckpt, device="cpu")
    assert codec.cfg == lcfg and codec.samples_per_frame == 8
    audio = (0.5 * np.random.default_rng(2).normal(size=(1, 2, 64))).astype(np.float32)
    _close(oobleck.encode(lp, lcfg, torch.from_numpy(audio)),
           joob.encode(jp, jcfg, jnp.asarray(audio)))
    _close(torch.from_numpy(codec.encode_audio(audio)), joob.encode(jp, jcfg, jnp.asarray(audio)))
    z = np.random.default_rng(3).normal(size=(1, 5, 4)).astype(np.float32)
    _close(torch.from_numpy(codec.decode_latents(z)),
           joob.decode(jp, jcfg, jnp.asarray(z.transpose(0, 2, 1))))
