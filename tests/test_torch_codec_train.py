"""The port's VAE-GAN codec trainer against the JAX package's, f32 on the
CPU at tiny widths, with JAX's draws injected (normal(rng) and
uniform(fold_in(rng, 1)), rng = fold_in(key, step)): for each codec kind
(sigma with an EMA and a latent mask, LSGAN; melvae with a frozen encoder
and a latent mask, LSGAN; the stereo Oobleck with a frozen encoder, hinge,
`LossWeights.oobleck_default()`) a generator step, a discriminator step
and a second generator step: every step's metrics within 1e-5 of max(1,
|ref|), params within 1e-2·lr after one update. The JAX melvae kind
raises as the package jits it (its `melvae.forward` traces
`freeze_encoder` and `latent_mask_ratio` and branches on them), so its
reference runs that function's body jitted with both static. Also: the
frozen encoders (the melvae one against the port's own unfrozen update
too), the warm-up gate (gan_on False and True before warm-up give the
same update), the schedules and the optimizer against optax over 5
steps, `flow_space_kl` with injected noise (value and gradients), a
`CodecTrainState` checkpoint round trip, and K4's gradient repair (the
wrapper raises under autograd; the unfused block's gradients equal those
through `convnext_block_plain`)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kalle_tpu.models.codecs import discriminators as jdisc
from kalle_tpu.models.codecs import melvae as jmel
from kalle_tpu.models.codecs import oobleck as joob
from kalle_tpu.models.codecs import sigmavae as jsig
from kalle_tpu.train import codec_trainer as jct
from kalle_tpu.train import flow_kl as jfk
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.checkpoint import CheckpointManager
from kalle_tpu_torch.models.codecs import discriminators as disc
from kalle_tpu_torch.models.codecs import melvae, oobleck, sigmavae
from kalle_tpu_torch.ops.kernels import convnext_block as k4
from kalle_tpu_torch.train import codec_trainer as ct
from kalle_tpu_torch.train import flow_kl

LR = 1e-3
RES = ((256, 64, 256), (512, 128, 512))
OOB = dict(channels=4, latent_dim=4, encoder_out_dim=8, c_mults=(1, 2), strides=(2, 4),
           sample_rate=16000)
KINDS = {
    "sigma": dict(cfg=sigmavae.SigmaVAEConfig.tiny(), jcfg=jsig.SigmaVAEConfig.tiny(),
                  init=sigmavae.init_params, ch=1, adv="lsgan", weights=ct.LossWeights(),
                  ema=True, mask=0.1, freeze=False),
    "melvae": dict(cfg=melvae.MelVAEConfig.tiny(), jcfg=jmel.MelVAEConfig.tiny(),
                   init=melvae.init_params, ch=1, adv="lsgan", weights=ct.LossWeights(),
                   ema=False, mask=0.1, freeze=True),
    "oobleck": dict(cfg=oobleck.OobleckConfig(**OOB), jcfg=joob.OobleckConfig(**OOB),
                    init=oobleck.init_params, ch=2, adv="hinge",
                    weights=ct.LossWeights.oobleck_default(), ema=False, mask=0.0,
                    freeze=True),
}
T = 1024


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wav(ch, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    left = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.normal(size=T)
    chans = [left, 0.9 * np.roll(left, 8)][:ch]
    return np.stack([np.stack(chans), np.stack(chans)[..., ::-1] * 0.7]).astype(np.float32)


def _target(kind):
    """The clip each kind trains on. The mel-VAE's is silence: the
    log-magnitude L1 has a kink wherever a bin of the reconstruction equals
    the target's, and the two packages' reconstructions differ by f32
    rounding (~3e-7), which flips the sign of the L1 at any bin within that
    of a tie and moves an Adam update by up to 2·lr. Against silence every
    bin of the tiny mel-VAE's output is > 100x the target's (1e-6, the
    clamp), so no bin is near a tie."""
    wav = _wav(KINDS[kind]["ch"])
    return np.zeros_like(wav) if kind == "melvae" else wav


def _latent_shape(kind, cfg, params, wav):
    with torch.no_grad():
        x = torch.from_numpy(wav).transpose(1, 2)
        if kind == "sigma":
            return tuple(sigmavae.encode_nwc(params, cfg, x).shape)
        if kind == "melvae":
            return tuple(melvae.forward(params, cfg, torch.from_numpy(wav),
                                        torch.Generator())[1][1].transpose(1, 2).shape)
        b, t, c = oobleck.encode_nwc(params, cfg, x).shape
        return (b, t, c // 2)


def _draws(key, step, shape):
    rng = jax.random.fold_in(key, step)
    return (torch.from_numpy(np.array(jax.random.normal(rng, shape))),
            torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(rng, 1), shape))))


def _np(tree):
    """A numpy copy of a torch param tree (params_to_numpy shares memory on
    the CPU, and the steps update in place)."""
    return bridge.tree_map(lambda t: t.detach().clone().numpy(), tree)


def _fresh(kind, seed=0):
    """(gen, disc) param trees of the port's init, as torch and numpy."""
    spec = KINDS[kind]
    dcfg = disc.DiscriminatorConfig.tiny(spec["ch"])
    gen = spec["init"](spec["cfg"], torch.Generator().manual_seed(seed), "cpu")
    if kind == "melvae":
        # at its N(0, 0.01) init the mel-VAE decoder is near-silent (output std
        # ~6e-4, STFT bins down to ~4e-6); a louder last conv (std ~0.02) keeps
        # its bins above the f32 noise of the two DFTs (see _target)
        gen["decoder"]["conv_post"]["w"] *= 30.0
    dp = disc.init_params(dcfg, torch.Generator().manual_seed(seed + 1), "cpu")
    return gen, dp, dcfg


def _melvae_forward_static():
    """The JAX package's melvae.forward, its body unchanged, jitted with
    freeze_encoder and latent_mask_ratio static: as the package jits it,
    they are traced and its `if` on them raises, so its codec trainer
    cannot run the melvae kind at all."""
    return functools.partial(jax.jit, static_argnames=(
        "cfg", "freeze_encoder", "latent_mask_ratio"))(jmel.forward.__wrapped__)


@pytest.fixture(scope="module", params=list(KINDS))
def run(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmel, "forward", _melvae_forward_static())
        return _run(request.param)


def test_jax_melvae_trainer_needs_static_flags():
    """The fault the fixture works round, in the JAX package as it is."""
    cfg = jmel.MelVAEConfig.tiny()
    params = jax.tree.map(jnp.asarray, _np(melvae.init_params(
        melvae.MelVAEConfig.tiny(), torch.Generator().manual_seed(0), "cpu")))
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax.jit(lambda p, w: jct._reconstruct("melvae", cfg, p, w, jax.random.key(0))[1])(
            params, jnp.asarray(_wav(1)))


def _run(kind):
    """Both packages through generator, discriminator, generator steps."""
    spec = KINDS[kind]
    cfg, jcfg = spec["cfg"], spec["jcfg"]
    gen, dp, dcfg = _fresh(kind)
    jgen, jdp = _np(gen), _np(dp)
    wav = _target(kind)
    shape = _latent_shape(kind, cfg, gen, wav)
    kw = dict(warmup_steps=0, resolutions=RES, freeze_encoder=spec["freeze"],
              latent_mask_ratio=spec["mask"], adv_type=spec["adv"])

    key = jax.random.key(3)
    jtx = jct.make_codec_optimizer(LR)
    jdcfg = jdisc.DiscriminatorConfig.tiny(spec["ch"])
    jw = jct.LossWeights(**dataclasses.asdict(spec["weights"]))
    js = jct.make_state(jax.tree.map(jnp.asarray, jgen), jax.tree.map(jnp.asarray, jdp), jtx,
                        jtx, use_ema=spec["ema"])
    ref = []
    js, m = jct.generator_step(js, kind, jcfg, jdcfg, jtx, jw, jnp.asarray(wav), key, **kw)
    ref.append((m, js))
    js, m = jct.discriminator_step(js, kind, jcfg, jdcfg, jtx, jnp.asarray(wav), key,
                                   adv_type=spec["adv"])
    ref.append((m, js))
    js, m = jct.generator_step(js, kind, jcfg, jdcfg, jtx, jw, jnp.asarray(wav), key, **kw)
    ref.append((m, js))

    tx = ct.make_codec_optimizer(LR)
    st = ct.make_state(gen, dp, tx, tx, use_ema=spec["ema"])
    twav = torch.from_numpy(wav)
    got = []
    for i, step in enumerate(("gen", "disc", "gen")):
        noise, mask = _draws(key, st.step, shape)
        if step == "gen":
            st, m = ct.generator_step(st, kind, cfg, dcfg, spec["weights"], twav, noise=noise,
                                      mask_uniform=mask if spec["mask"] else None, **kw)
        else:
            st, m = ct.discriminator_step(st, kind, cfg, dcfg, twav, noise=noise,
                                          adv_type=spec["adv"])
        got.append((m, {"gen": _np(st.gen_params), "disc": _np(st.disc_params),
                        "ema": _np(st.gen_ema) if st.gen_ema else None,
                        "step": st.step}))
    return kind, got, ref, jgen


def _metrics_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        r = float(ref[k])
        np.testing.assert_allclose(float(got[k]), r, atol=1e-5 * max(1.0, abs(r)), rtol=0,
                                   err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _params_close(got, ref, atol):
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    for k in r:
        assert g[k].shape == r[k].shape, k
        np.testing.assert_allclose(g[k], r[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["gen", "disc", "gen_again"])
def test_step_metrics(run, i):
    _, got, ref, _ = run
    _metrics_close(got[i][0], ref[i][0])


def test_generator_params_after_one_update(run):
    _, got, ref, _ = run
    _params_close(got[0][1]["gen"], ref[0][1].gen_params, 1e-2 * LR)
    assert got[0][1]["step"] == int(ref[0][1].step) == 1


def test_discriminator_params_after_one_update(run):
    _, got, ref, _ = run
    _params_close(got[1][1]["disc"], ref[1][1].disc_params, 1e-2 * LR)
    assert got[1][1]["step"] == int(ref[1][1].step) == 1  # the disc step does not count


def test_adversarial_terms_present(run):
    kind, got, _, _ = run
    m = got[0][0]
    assert float(m["adv_g"]) != 0.0 and float(m["fm"]) > 0.0
    assert np.isfinite([float(v) for v in m.values()]).all()


def test_frozen_encoder_and_ema(run):
    kind, got, ref, jgen = run
    if kind != "sigma":  # frozen: zero gradients, so AdamW's decay alone moved the encoder
        _params_close(got[0][1]["gen"]["encoder"],
                      jax.tree.map(lambda a: a * (1 - LR * 1e-4), jgen["encoder"]), 1e-7)
    if kind == "sigma":  # decay 0 at step 0: the EMA is the updated params; then it lags
        _params_close(got[0][1]["ema"], ref[0][1].gen_ema, 1e-2 * LR)
        _params_close(got[0][1]["ema"], got[0][1]["gen"], 1e-7)
        d = ct.ema_decay(1)
        _params_close(got[2][1]["ema"], jax.tree.map(lambda e, p: e + (1 - d) * (p - e),
                                                     got[0][1]["ema"], got[2][1]["gen"]), 1e-7)
        assert max(np.abs(a - b).max() for a, b in zip(_flat(got[2][1]["ema"]).values(),
                                                        _flat(got[2][1]["gen"]).values())) > 0
    else:
        assert got[0][1]["ema"] is None


def test_melvae_freeze_encoder():
    """The frozen encoder gets zero gradients (only AdamW's decay moves it);
    everything else takes the update of the unfrozen step, which the JAX
    parity above holds."""
    spec = KINDS["melvae"]
    wav = torch.from_numpy(_wav(1))
    noise = torch.randn(_latent_shape("melvae", spec["cfg"], _fresh("melvae")[0], _wav(1)),
                        generator=torch.Generator().manual_seed(4))
    out = []
    for freeze in (False, True):
        gen, dp, dcfg = _fresh("melvae")
        p0 = _np(gen)
        tx = ct.make_codec_optimizer(LR)
        st = ct.make_state(gen, dp, tx, tx)
        _, m = ct.generator_step(st, "melvae", spec["cfg"], dcfg, spec["weights"], wav,
                                 resolutions=RES, freeze_encoder=freeze, noise=noise)
        out.append((m, _np(st.gen_params)))
    (ma, pa), (mb, pb) = out
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    _params_close({k: v for k, v in pb.items() if k != "encoder"},
                  {k: v for k, v in pa.items() if k != "encoder"}, 0.0)
    _params_close(pb["encoder"], jax.tree.map(lambda a: a * (1 - LR * 1e-4), p0["encoder"]),
                  1e-7)
    assert max(np.abs(a - b).max() for a, b in zip(_flat(pa["encoder"]).values(),
                                                    _flat(p0["encoder"]).values())) > 1e-5


def _tiny_sigma_state(use_ema=False):
    gen, dp, dcfg = _fresh("sigma")
    tx = ct.make_codec_optimizer(LR)
    return ct.make_state(gen, dp, tx, tx, use_ema=use_ema), dcfg


def test_warmup_gate_equals_recon_only_update():
    """Before warm-up the update with the GAN on equals the update with no
    discriminator op (as the JAX test asserts), and the gated run still
    reports the adversarial metrics."""
    cfg = sigmavae.SigmaVAEConfig.tiny()
    wav = torch.from_numpy(_wav(1))
    heavy = ct.LossWeights(mrstft=1.0, l1=0.5, kl=1e-4, adv=100.0, fm=100.0)
    noise = torch.from_numpy(np.random.default_rng(1).normal(size=(2, T // 8, 8))
                             .astype(np.float32))
    out = []
    for gan_on in (True, False):
        st, dcfg = _tiny_sigma_state()
        st, m = ct.generator_step(st, "sigma", cfg, dcfg, heavy, wav, warmup_steps=10,
                                  gan_on=gan_on, resolutions=RES, noise=noise)
        out.append((m, _np(st.gen_params)))
    (ma, pa), (mb, pb) = out
    for k in ("mrstft", "l1", "mse", "kl", "gen_total"):
        assert float(ma[k]) == float(mb[k]), k
    assert float(ma["adv_g"]) > 0 and float(ma["fm"]) > 0
    assert float(mb["adv_g"]) == 0 and float(mb["fm"]) == 0
    _params_close(pa, pb, 0.0)
    st, dcfg = _tiny_sigma_state()
    st, _ = ct.generator_step(st, "sigma", cfg, dcfg, heavy, wav, warmup_steps=1,
                              resolutions=RES, noise=noise)
    _, m = ct.generator_step(st, "sigma", cfg, dcfg, heavy, wav, warmup_steps=1,
                             resolutions=RES, noise=noise)
    assert float(m["gen_total"]) > float(m["mrstft"]) + 1.0  # warmed: the terms enter


def test_freeze_encoder_stops_encoder_gradients():
    cfg = sigmavae.SigmaVAEConfig.tiny()
    params = sigmavae.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in bridge.tree_leaves(params):
        p.requires_grad_(True)
    wav = torch.from_numpy(_wav(1))
    for freeze in (False, True):
        wav_hat, kl = ct._reconstruct("sigma", cfg, params, wav, torch.Generator(),
                                      freeze_encoder=freeze)
        loss = (wav_hat ** 2).mean() + kl
        enc = bridge.tree_leaves(params["encoder"])
        dec = bridge.tree_leaves(params["decoder"])
        grads = torch.autograd.grad(loss, enc + dec, allow_unused=True, materialize_grads=True)
        enc_norm = sum(float(g.abs().sum()) for g in grads[:len(enc)])
        assert (enc_norm == 0.0) == freeze
        assert sum(float(g.abs().sum()) for g in grads[len(enc):]) > 0


def test_latent_mask_changes_decode_not_kl():
    cfg = sigmavae.SigmaVAEConfig.tiny()
    params = sigmavae.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.from_numpy(_wav(1))
    noise = torch.randn(2, T // 8, 8, generator=torch.Generator().manual_seed(1))
    u = torch.rand(2, T // 8, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        base, kl0 = ct._reconstruct("sigma", cfg, params, wav, noise=noise)
        masked, kl1 = ct._reconstruct("sigma", cfg, params, wav, noise=noise,
                                      latent_mask_ratio=0.5, mask_uniform=u)
    assert not torch.allclose(base, masked)
    assert float(kl0) == float(kl1)


@pytest.mark.parametrize("kw", [dict(), dict(use_inverse_lr=True, inv_gamma=2.0, power=0.7,
                                               warmup=0.5, final_lr=1e-5)],
                         ids=["constant", "inverse_lr"])
def test_optimizer_against_optax(kw):
    """make_codec_optimizer: the torch AdamW behind its LambdaLR against
    optax's adamw over 5 updates of the same gradients."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]} for _ in range(5)]
    jtx = jct.make_codec_optimizer(3e-3, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jtx.init(jp)
    tp = bridge.params_from_jax(p0, device="cpu")
    leaves = bridge.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = ct.make_codec_optimizer(3e-3, **kw).build(leaves)
    for g in grads:
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        for p, gg in zip(leaves, bridge.tree_leaves(bridge.params_from_jax(g, device="cpu"))):
            p.grad = gg
        opt.step()
        sched.step()
        _params_close(_np(tp), jp, 1e-2 * 3e-3)


def test_schedules_against_jax():
    kw = dict(inv_gamma=200.0, power=0.7, warmup=0.99, final_lr=1e-6)
    ours, ref = ct.inverse_lr_schedule(1.5e-4, **kw), jct.inverse_lr_schedule(1.5e-4, **kw)
    # the JAX package's own check of this schedule: rtol 1e-6 over these steps
    # (the JAX schedule computes in f32, the port in double)
    for step in range(0, 2000, 37):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))), rtol=1e-6)
        np.testing.assert_allclose(ct.ema_decay(step), float(jct.ema_decay(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-7)
    assert ct.ema_decay(0) == 0.0 and 0 < ct.ema_decay(10) < ct.ema_decay(1000) < 0.9999


def test_cosine_adam_against_optax():
    from kalle_tpu_torch.train.optim import adam_cosine, cosine_decay

    sched = optax.cosine_decay_schedule(2e-3, 4, 0.05)
    ours = cosine_decay(2e-3, 4, 0.05)
    for n in range(7):
        np.testing.assert_allclose(ours(n), float(sched(n)), rtol=1e-6)
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(6,)).astype(np.float32)
    tx = optax.adam(sched)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt, lr = adam_cosine([tp], 2e-3, 4, 0.05)
    for _ in range(5):
        g = rng.normal(size=(6,)).astype(np.float32)
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g)
        opt.step()
        lr.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-2 * 2e-3)


@pytest.fixture(scope="module")
def flow_setup():
    cfg = melvae.MelVAEConfig.tiny()
    params = melvae.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    for f in params["flows"]:  # a fresh flow is the identity: give it a body
        f["post"]["w"] = 0.1 * torch.randn(f["post"]["w"].shape, generator=g)
    return cfg, params, bridge.params_to_numpy(params)


@pytest.mark.parametrize("uniform", [False, True], ids=["normal", "uniform"])
def test_flow_space_kl(flow_setup, uniform):
    cfg, params, jp = flow_setup
    rng = np.random.default_rng(2)
    b, t, d = 2, 9, cfg.latent_dim
    mean = rng.normal(size=(b, t, d)).astype(np.float32)
    logs = (0.3 * rng.normal(size=(b, t, d))).astype(np.float32)
    labels = np.concatenate([rng.normal(size=(b, t, d)), 0.3 * rng.normal(size=(b, t, d))],
                            -1).astype(np.float32)
    tm = (rng.random((b, t)) > 0.3).astype(np.float32)
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    draw = jax.random.uniform if uniform else jax.random.normal
    noise = (torch.from_numpy(np.array(draw(k1, (b, t, d)))),
             torch.from_numpy(np.array(draw(k2, (b, t, d)))))
    jparams = jax.tree.map(jnp.asarray, jp)

    def jloss(m, s):
        return jfk.flow_space_kl(jparams, jmel.MelVAEConfig.tiny(),
                                 {"pre_mean": m, "pre_log_scale": s}, jnp.asarray(labels),
                                 jnp.asarray(tm), key, uniform_noise=uniform)

    ref, (gm, gs) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(mean),
                                                              jnp.asarray(logs))
    for p in bridge.tree_leaves(params):
        p.requires_grad_(True)
    tmean = torch.from_numpy(mean).requires_grad_(True)
    tlogs = torch.from_numpy(logs).requires_grad_(True)
    got = flow_kl.flow_space_kl(params, cfg, {"pre_mean": tmean, "pre_log_scale": tlogs},
                                torch.from_numpy(labels), torch.from_numpy(tm), noise=noise)
    g_mean, g_logs = torch.autograd.grad(got, (tmean, tlogs), materialize_grads=True)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    # the flow's output is a constant to autograd, so the mean's gradient is
    # 0 in both; the log-scale's reaches it through the predicted std
    assert float(np.abs(gm).max()) == 0.0 and float(g_mean.abs().max()) == 0.0
    assert float(g_logs.abs().max()) > 0
    np.testing.assert_allclose(g_logs.numpy(), np.asarray(gs),
                               atol=1e-5 * max(1.0, float(np.abs(gs).max())))
    assert all(p.grad is None for p in bridge.tree_leaves(params))
    for p in bridge.tree_leaves(params):
        p.requires_grad_(False)


def test_flow_space_kl_draws_from_generator(flow_setup):
    cfg, params, _ = flow_setup
    x = torch.randn(1, 4, 2 * cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    out = {"pre_mean": x[..., :cfg.latent_dim], "pre_log_scale": 0.1 * x[..., cfg.latent_dim:]}
    a, b = (flow_kl.flow_space_kl(params, cfg, out, x, torch.ones(1, 4),
                                  torch.Generator().manual_seed(s)) for s in (0, 0))
    assert float(a) == float(b) and np.isfinite(float(a))


def test_checkpoint_round_trip(tmp_path):
    """The whole CodecTrainState (both params, both optimizer states, both
    schedules, the EMA, the step) restores leaf for leaf bit-equal, and
    training continues from it exactly as from the original."""
    cfg = sigmavae.SigmaVAEConfig.tiny()
    wav = torch.from_numpy(_wav(1))
    st, dcfg = _tiny_sigma_state(use_ema=True)
    g = torch.Generator().manual_seed(7)
    st, _ = ct.generator_step(st, "sigma", cfg, dcfg, ct.LossWeights(), wav, g, resolutions=RES)
    st, _ = ct.discriminator_step(st, "sigma", cfg, dcfg, wav, g)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(st.step, st, wait=True)
    mgr.close()
    gen, dp, _ = _fresh("sigma", seed=9)
    tx = ct.make_codec_optimizer(LR)
    tmpl = ct.make_state(gen, dp, tx, tx, use_ema=True)
    restored, step = CheckpointManager(str(tmp_path / "ckpt")).restore(tmpl)
    assert step == st.step == restored.step == 1

    def leaves(s):
        sd = s.state_dict()
        opt = [v for o in ("gen_opt", "disc_opt") for per in sd[o]["state"].values()
               for v in per.values()]
        return bridge.tree_leaves([sd["gen_params"], sd["disc_params"], sd["gen_ema"]]) + opt

    a, b = leaves(st), leaves(restored)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert restored.gen_sched.state_dict() == st.gen_sched.state_dict()
    noise = torch.randn(2, T // 8, 8, generator=torch.Generator().manual_seed(8))
    ma = ct.generator_step(st, "sigma", cfg, dcfg, ct.LossWeights(), wav, resolutions=RES,
                           noise=noise)[1]
    mb = ct.generator_step(restored, "sigma", cfg, dcfg, ct.LossWeights(), wav,
                           resolutions=RES, noise=noise)[1]
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    _params_close(_np(st.gen_params), _np(restored.gen_params), 0.0)


def _block_params(c, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: 0.3 * torch.randn(*s, generator=g)
    return {"norm": 1 + r(c), "dw": {"w": r(7, 1, c), "b": r(c)},
            "up": {"w": r(1, c, 4 * c), "b": r(4 * c)}, "down": {"w": r(1, 2 * c, c), "b": r(c)}}


def test_convnext_block_raises_under_autograd():
    p = _block_params(16, 0)
    x = torch.randn(2, 9, 16)
    args = (p["norm"], p["dw"]["w"], p["dw"]["b"], p["up"]["w"], p["up"]["b"],
            p["down"]["w"], p["down"]["b"])
    k4.convnext_block(x, *args)  # nothing requires grad: the plain version runs
    with pytest.raises(RuntimeError, match="no backward"):
        k4.convnext_block(x.requires_grad_(True), *args)
    with torch.no_grad():
        k4.convnext_block(x, *args)


def test_unfused_block_gradients_equal_plain_kernel_gradients():
    """f32: autograd through sigmavae's unfused block (what training runs)
    equals autograd through K4's plain version, within 1e-5."""
    cfg = sigmavae.SigmaVAEConfig(channels=(16, 16), strides=(2,), blocks_per_stage=1)
    p = _block_params(16, 1)
    x0 = torch.randn(2, 11, 16, generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (lambda x, q: sigmavae._block(x, q, cfg),
               lambda x, q: k4.convnext_block_plain(x, q["norm"], q["dw"]["w"], q["dw"]["b"],
                                                    q["up"]["w"], q["up"]["b"],
                                                    q["down"]["w"], q["down"]["b"])):
        q = bridge.tree_map(lambda t: t.clone().requires_grad_(True), p)
        x = x0.clone().requires_grad_(True)
        out = fn(x, q)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append([x.grad] + [t.grad for t in bridge.tree_leaves(q)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
