"""The port's codec losses and discriminators against the JAX package's,
f32 on the CPU, within 1e-5 of max |ref|: every loss of `codec_losses`
(a resolution longer than the signal skipped but still counted, the
doubled sd-STFT of `w_sd=2.0`, hinge and least-squares terms, feature
matching), and the discriminator's logits and every feature at `tiny()`,
a stereo `tiny(2)` and `DiscriminatorConfig()` on a clip shorter than its
longest resolution, from one set of weights carried over by the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.models.codecs import discriminators as jdisc
from kalle_tpu.train import codec_losses as jl
from kalle_tpu_torch import bridge
from kalle_tpu_torch.models.codecs import discriminators as disc
from kalle_tpu_torch.train import codec_losses as tl

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, np.abs(ref).max()), rtol=0)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    y = (0.5 * rng.normal(size=shape)).astype(np.float32)
    x = (y + 0.2 * rng.normal(size=shape)).astype(np.float32)
    return x, y


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("res", [(512, 128, 512), (256, 50, 240)])
def test_stft_loss(res):
    x, y = _pair((2, 1500), 0)
    got = tl.stft_loss(*_t(x, y), *res)
    ref = jl.stft_loss(jnp.asarray(x), jnp.asarray(y), *res)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("t", [1500, 2400])
def test_multi_resolution_stft_loss_counts_skipped_resolutions(t):
    """At t 1500 the 2048-point resolution is skipped, and the sum is still
    divided by 3."""
    x, y = _pair((2, t), 1)
    got = tl.multi_resolution_stft_loss(*_t(x, y))
    _close(got, jl.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y)))
    kept = [r for r in tl.DEFAULT_RESOLUTIONS if r[0] <= t]
    alone = sum(float(sum(tl.stft_loss(*_t(x, y), *r))) for r in kept) / 3
    np.testing.assert_allclose(float(got), alone, rtol=1e-6)
    assert (t < 2048) == (len(kept) == 2)


@pytest.mark.parametrize("w_sd", [2.0, 1.0])
def test_sum_and_difference_stft_loss(w_sd):
    x, y = _pair((2, 2, 2100), 2)
    got = tl.sum_and_difference_stft_loss(*_t(x, y), w_sd=w_sd)
    _close(got, jl.sum_and_difference_stft_loss(jnp.asarray(x), jnp.asarray(y), w_sd=w_sd))


def test_sum_and_difference_default_counts_sd_twice():
    x, y = _pair((2, 2, 1100), 3)
    res = ((512, 128, 512),)
    sd = tl.sum_and_difference_stft_loss(*_t(x, y), res, w_sd=1.0, w_lr=0.0)
    both = tl.sum_and_difference_stft_loss(*_t(x, y), res)
    lr = tl.sum_and_difference_stft_loss(*_t(x, y), res, w_sd=0.0)
    np.testing.assert_allclose(float(both), 2 * float(sd) + float(lr), rtol=1e-6)


def test_time_and_kl_losses():
    x, y = _pair((3, 1, 700), 4)
    _close(tl.l1_time_loss(*_t(x, y)), jl.l1_time_loss(jnp.asarray(x), jnp.asarray(y)))
    m, s = _pair((2, 5, 8), 5)
    _close(tl.vae_kl_loss(*_t(m, s)), jl.vae_kl_loss(jnp.asarray(m), jnp.asarray(s)))


def _logits(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 7 + i, 1)).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("name", ["generator_adv_loss", "generator_hinge_loss"])
def test_generator_adversarial_losses(name):
    fake = _logits(6)
    got = getattr(tl, name)(_t(*fake))
    _close(got, getattr(jl, name)([jnp.asarray(f) for f in fake]))


def test_generator_hinge_is_summed_over_scales():
    fake = _logits(7)
    np.testing.assert_allclose(float(tl.generator_hinge_loss(_t(*fake))),
                               -sum(float(f.mean()) for f in fake), rtol=1e-6)


@pytest.mark.parametrize("name", ["discriminator_adv_loss", "discriminator_hinge_loss"])
def test_discriminator_adversarial_losses(name):
    real, fake = _logits(8), _logits(9)
    got = getattr(tl, name)(_t(*real), _t(*fake))
    _close(got, getattr(jl, name)([jnp.asarray(r) for r in real],
                                  [jnp.asarray(f) for f in fake]))


def test_feature_matching_loss():
    rng = np.random.default_rng(10)
    real = [[rng.normal(size=(2, 9 - j, 4 * (j + 1))).astype(np.float32) for j in range(3)]
            for _ in range(2)]
    fake = [[(a + 0.1 * rng.normal(size=a.shape)).astype(np.float32) for a in r] for r in real]
    got = tl.feature_matching_loss([_t(*r) for r in real], [_t(*f) for f in fake])
    _close(got, jl.feature_matching_loss([[jnp.asarray(a) for a in r] for r in real],
                                         [[jnp.asarray(a) for a in f] for f in fake]))


CONFIGS = {"tiny": (disc.DiscriminatorConfig.tiny(), jdisc.DiscriminatorConfig.tiny(), 1, 1200),
           "tiny_stereo": (disc.DiscriminatorConfig.tiny(2), jdisc.DiscriminatorConfig.tiny(2),
                           2, 1201),
           "default_short": (disc.DiscriminatorConfig(), jdisc.DiscriminatorConfig(), 1, 1536),
           "encodec_stereo_short": (disc.DiscriminatorConfig.encodec_stereo(),
                                    jdisc.DiscriminatorConfig.encodec_stereo(), 2, 1100)}


def _shapes(tree, prefix=""):
    """{path: shape} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _shapes(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _shapes(v, f"{prefix}/{i}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_discriminator_forward(name):
    cfg, jcfg, ch, t = CONFIGS[name]
    tp = disc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_tree = jax.eval_shape(lambda k: jdisc.init_params(jcfg, k), jax.random.key(0))
    assert _shapes(tp) == _shapes(ref_tree)
    jp = bridge.params_to_numpy(tp)
    wav = (0.5 * np.random.default_rng(11).normal(size=(2, ch, t))).astype(np.float32)
    logits, feats = disc.forward(tp, cfg, torch.from_numpy(wav))
    rl, rf = jdisc.forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(wav))
    skipped = sum(n > t for n, _, _ in cfg.mrd_resolutions)
    assert len(logits) == len(rl) == len(cfg.periods) + len(cfg.mrd_resolutions) - skipped
    if name.endswith("short"):
        assert skipped >= 1
    for g, r in zip(logits, rl):
        _close(g, r)
    assert [len(f) for f in feats] == [len(f) for f in rf] == [cfg.n_layers] * len(rl)
    for gs, rs in zip(feats, rf):
        for g, r in zip(gs, rs):
            _close(g, r)


def test_period_phases_fold_phase_major():
    """(B, C, T) with C 2: frame k of period p holds samples kp..kp+p-1 of
    both channels, the audio channel fastest, as the JAX reshape of NWC."""
    cfg = disc.DiscriminatorConfig(periods=(3,), mrd_resolutions=(), channels=4, n_layers=1,
                                   in_channels=2)
    p = disc.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    w = torch.zeros(5, 6, 4)
    w[2, :, 0] = torch.arange(6.0)  # centre tap reads channel j with weight j
    p["mpd"][0][0] = {"w": w, "b": torch.zeros(4)}
    wav = torch.arange(2 * 7, dtype=torch.float32).reshape(1, 2, 7)
    _, feats = disc.forward(p, cfg, wav)
    x = torch.nn.functional.pad(wav.transpose(1, 2), (0, 0, 0, 2)).reshape(1, 3, 6)
    want = torch.nn.functional.leaky_relu((x * torch.arange(6.0)).sum(-1)[:, ::2], 0.1)
    torch.testing.assert_close(feats[0][0][..., 0], want)
