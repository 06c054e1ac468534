"""The port's speaker conditioning against the JAX package's, f32 on the
CPU at tiny widths, within 1e-4 of max |ref|: the ECAPA-TDNN speaker
encoder and the MRTE timbre encoder, each from the JAX init (carried over
by `bridge.params_from_jax`) and from an in-code random torch state dict
through both importers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.conditioning import ecapa as jecapa
from kalle_tpu.models.conditioning import mrte as jmrte
from kalle_tpu_torch import bridge
from kalle_tpu_torch.models.conditioning import ecapa, mrte

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
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()), rtol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _same_trees(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), atol=1e-6, rtol=0, err_msg=k)


class _SD(dict):
    """A random torch state dict built key by key."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def t(self, *shape, scale=0.3, positive=False):
        a = scale * self.rng.normal(size=shape)
        return torch.from_numpy((np.abs(a) + 0.5 if positive else a).astype(np.float32))

    def conv(self, prefix, cout, cin, k, bias=True):
        self[prefix + ".weight"] = self.t(cout, cin, k, scale=(cin * k) ** -0.5)
        if bias:
            self[prefix + ".bias"] = self.t(cout)

    def lin(self, prefix, cout, cin):
        self[prefix + ".weight"], self[prefix + ".bias"] = self.t(cout, cin, scale=cin ** -0.5), \
            self.t(cout)

    def bn(self, prefix, c):
        self[prefix + ".weight"], self[prefix + ".bias"] = self.t(c, positive=True), self.t(c)
        self[prefix + ".running_mean"] = self.t(c)
        self[prefix + ".running_var"] = self.t(c, positive=True)

    def ln(self, prefix, c):
        self[prefix + ".weight"], self[prefix + ".bias"] = self.t(c, positive=True), self.t(c)


def _ecapa_sd(cfg, seed):
    sd = _SD(seed)
    ch, w = cfg.channels, cfg.channels // cfg.scale
    sd.conv("layer1.conv", ch, cfg.in_channels, 5, bias=False)
    sd.bn("layer1.bn", ch)
    for n in (2, 3, 4):
        base = f"layer{n}"
        sd.conv(f"{base}.0.conv", ch, ch, 1, bias=False)
        sd.bn(f"{base}.0.bn", ch)
        for i in range(cfg.scale - 1):
            sd.conv(f"{base}.1.convs.{i}", w, w, 3, bias=False)
            sd.bn(f"{base}.1.bns.{i}", w)
        sd.conv(f"{base}.2.conv", ch, ch, 1, bias=False)
        sd.bn(f"{base}.2.bn", ch)
        sd.lin(f"{base}.3.linear1", ch // 2, ch)
        sd.lin(f"{base}.3.linear2", ch, ch // 2)
    sd.conv("conv", cfg.pooled_channels, 3 * ch, 1)
    sd.conv("pooling.linear1", cfg.attn_bottleneck, cfg.pooled_channels, 1)
    sd.conv("pooling.linear2", cfg.pooled_channels, cfg.attn_bottleneck, 1)
    sd.bn("bn1", 2 * cfg.pooled_channels)
    sd.lin("linear", cfg.embd_dim, 2 * cfg.pooled_channels)
    sd.bn("bn2", cfg.embd_dim)
    return dict(sd)


def _mrte_sd(cfg, seed):
    sd = _SD(seed)
    h, k = cfg.hidden_size, cfg.kernel_size
    sd.conv("mel_encoder.first_layer", h, cfg.mel_bins, k)
    sd.conv("mel_encoder_middle_layer", h, h, cfg.mel_stride + 1)
    for i in range(cfg.n_layers):
        for which in ("conv_stack1", "conv_stack2"):
            for s in range(cfg.n_stacks):
                for b in range(cfg.n_blocks):
                    bb = f"mel_encoder.layers.{i}.{which}.conv_stacks.{s}.blocks.{b}"
                    sd.conv(bb + ".conv", h, h, k)
                    sd.ln(bb + ".norm", h)
    sd.conv("mel_encoder.last_layer", h, h, k)
    for name in ("mha.w_q", "mha.w_k", "mha.w_v", "mha.out_proj.0"):
        sd.lin(name, h, h)
    sd.ln("norm", h)
    sd.lin("adapter_cond_emb", 2048, h)
    return dict(sd)


@pytest.mark.parametrize("t", [23, 40])
def test_ecapa_forward(t):
    jcfg, cfg = jecapa.EcapaConfig.tiny(), ecapa.EcapaConfig.tiny()
    jp = jax.tree.map(np.asarray, jecapa.init_params(jcfg, jax.random.key(0)))
    tp = bridge.params_from_jax(jp, device="cpu")
    mel = np.random.default_rng(t).normal(size=(2, t, cfg.in_channels)).astype(np.float32)
    got = ecapa.forward(tp, cfg, torch.from_numpy(mel))
    assert tuple(got.shape) == (2, cfg.embd_dim)
    _close(got, jecapa.forward(jp, jcfg, jnp.asarray(mel)))
    tree = ecapa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in _flat(tree).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jp).items()}


def test_ecapa_import():
    cfg = ecapa.EcapaConfig.tiny()
    sd = _ecapa_sd(cfg, 1)
    ref = jecapa.params_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    got = ecapa.params_from_state_dict(sd, cfg, device="cpu")
    _same_trees(got, ref)
    mel = np.random.default_rng(2).normal(size=(3, 30, cfg.in_channels)).astype(np.float32)
    _close(ecapa.forward(got, cfg, torch.from_numpy(mel)),
           jecapa.forward(jax.tree.map(jnp.asarray, ref), jecapa.EcapaConfig.tiny(),
                          jnp.asarray(mel)))


@pytest.mark.parametrize("t", [33, 48])
def test_mrte_forward(t):
    jcfg, cfg = jmrte.MRTEConfig.tiny(), mrte.MRTEConfig.tiny()
    jp = jax.tree.map(np.asarray, jmrte.init_params(jcfg, jax.random.key(0)))
    tp = bridge.params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(t)
    mel = rng.normal(size=(2, cfg.mel_bins, t)).astype(np.float32)
    phone = rng.normal(size=(2, 7, cfg.hidden_size)).astype(np.float32)
    cond, tc = mrte.forward(tp, cfg, torch.from_numpy(mel), torch.from_numpy(phone))
    rcond, rtc = jmrte.forward(jp, jcfg, jnp.asarray(mel), jnp.asarray(phone))
    assert tuple(cond.shape) == (2, 2048) and tuple(tc.shape) == (2, 7, cfg.hidden_size)
    _close(cond, rcond)
    _close(tc, rtc)
    tree = mrte.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in _flat(tree).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jp).items()}


def test_mrte_import():
    cfg = mrte.MRTEConfig.tiny()
    sd = _mrte_sd(cfg, 3)
    ref = jmrte.params_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    got = mrte.params_from_state_dict(sd, cfg, device="cpu")
    _same_trees(got, ref)
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(1, cfg.mel_bins, 37)).astype(np.float32)
    phone = rng.normal(size=(1, 5, cfg.hidden_size)).astype(np.float32)
    cond, tc = mrte.forward(got, cfg, torch.from_numpy(mel), torch.from_numpy(phone))
    rcond, rtc = jmrte.forward(jax.tree.map(jnp.asarray, ref), jmrte.MRTEConfig.tiny(),
                               jnp.asarray(mel), jnp.asarray(phone))
    _close(cond, rcond)
    _close(tc, rtc)
