"""The port's evaluation stack against the JAX package's, f32 on the CPU: the
synthetic-speech renderer bit-equal; the CTC ASR's log mel, forward,
training bank and one training step (loss within 1e-5 of optax's CTC,
gradients within 1e-5 of their leaf's largest, every element on Adam's rule
and params within 1e-2·lr where the gradient is above f32 noise), greedy
decoding and transcription; the speaker embedder's bank, one training step
and embeddings; the WER scorer's statistics and printed alignments on the
same .trn files; the harness's files and values (`wer_pipeline`,
`speaker_similarity`) with one injected transcriber and embedder; the
spectral and ECAPA embedders within 1e-5."""
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kalle_tpu.data import synth_speech as jsl
from kalle_tpu.eval import ctc_asr as jctc
from kalle_tpu.eval import harness as jh
from kalle_tpu.eval import speaker_embedder as jse
from kalle_tpu.eval import wer as jwer
from kalle_tpu_torch import bridge
from kalle_tpu_torch.data import synth_speech as sl
from kalle_tpu_torch.eval import ctc_asr, harness, speaker_embedder as se, wer
from kalle_tpu_torch.models.conditioning import ecapa
from kalle_tpu_torch.train.optim import adam_cosine
from kalle_tpu_torch.utils.audio import write_wav

TOL = 1e-5
LR = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, float(np.abs(ref).max())), rtol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _adam_step_close(got, ref, p0, g_got, g_ref, lr):
    """One Adam update of the same params in both packages, element by
    element. The gradients agree within 1e-5 of their leaf's largest (a
    leaf whose largest is within 1e-5 of the network's largest is rounding
    noise around a zero, as a bias under a shift-invariant softmax is, and
    is held at 1e-5 of the network's largest). In each package every
    element moved as Adam's first step says on that package's own gradient,
    -lr·g/(|g| + 1e-8), within 1e-2·lr. The two packages' params agree
    within 1e-2·lr wherever the gradient is above 1e-5 of its leaf's
    largest; below that Adam turns f32 rounding of the sums into a share of
    lr, so those elements are held by the rule alone, and they are at most
    5% of the elements that have a gradient."""
    flat = [_flat(t) for t in (got, ref, p0, g_got, g_ref)]
    assert all(f.keys() == flat[1].keys() for f in flat)
    s_net = max(float(np.abs(np.asarray(v)).max()) for v in flat[4].values())
    below = n = 0
    for k in flat[1]:
        a, b, a0, ga, gb = (np.asarray(f[k], np.float64) for f in flat)
        s_leaf = float(np.abs(gb).max())
        noise = s_leaf <= 1e-5 * s_net
        np.testing.assert_allclose(ga, gb, atol=1e-5 * (s_net if noise else s_leaf), rtol=0,
                                   err_msg=k)
        for x, g in ((a, ga), (b, gb)):
            np.testing.assert_allclose(x - a0, -lr * g / (np.abs(g) + 1e-8), atol=1e-2 * lr,
                                       rtol=0, err_msg=k)
        live = np.zeros(gb.shape, bool) if noise else np.abs(gb) >= 1e-5 * s_leaf
        np.testing.assert_allclose(a[live], b[live], atol=1e-2 * lr, rtol=0, err_msg=k)
        has_grad = (ga != 0) | (gb != 0)
        below += int((~live & has_grad).sum())
        n += int(has_grad.sum())
    assert below <= 0.05 * n, (below, n)


def _np(tree):
    return bridge.tree_map(lambda t: t.detach().clone().numpy(), tree)


# ---------------------------------------------------------------- renderer ----

@pytest.mark.parametrize("text,sr,spk,seed,fs", [
    ("hello world", 16000, 0, 0, 0.0), ("abc xyz", 24000, 5, 3, 0.0),
    ("the quick fox", 8000, 2, 1, 0.0), ("tiny", 2000, 1, 7, 0.0),
    ("q!z, ok", 16000, 3, 2, 0.5), ("", 16000, 0, 0, 0.0)])
def test_render_bit_equal(text, sr, spk, seed, fs):
    got = sl.render(text, sr, speaker=spk, seed=seed, freq_scale=fs)
    ref = jsl.render(text, sr, speaker=spk, seed=seed, freq_scale=fs)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_text_codes_equal():
    for text in ("hello world", "a!b c", "zz"):
        assert np.array_equal(sl.encode_text(text), jsl.encode_text(text))
        assert sl.decode_labels(sl.encode_text(text)) == jsl.decode_labels(jsl.encode_text(text))
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    assert [sl.random_sentence(a) for _ in range(5)] == [jsl.random_sentence(b) for _ in range(5)]
    assert sl.speaker_profile(4) == jsl.speaker_profile(4)


# ---------------------------------------------------------------- CTC ASR ----

@pytest.fixture(scope="module")
def ctc():
    cfg = ctc_asr.CTCConfig.tiny()
    tp = ctc_asr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, jctc.CTCConfig.tiny(), tp, _np(tp)


def test_ctc_config_and_init_tree(ctc):
    cfg, jcfg, tp, _ = ctc
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for sr in (16000, 24000, 44100):
        for tiny in (False, True):
            assert (dataclasses.asdict(ctc_asr.CTCConfig.for_sample_rate(sr, tiny))
                    == dataclasses.asdict(jctc.CTCConfig.for_sample_rate(sr, tiny)))
    ref = jax.eval_shape(lambda k: jctc.init_params(jcfg, k), jax.random.key(0))
    assert {k: v.shape for k, v in _flat(_np(tp)).items()} == \
        {k: tuple(v.shape) for k, v in _flat(ref).items()}


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_ctc_log_mel(ctc, scale):
    cfg, jcfg, _, _ = ctc
    wav = scale * sl.render("abc de", cfg.sample_rate, speaker=1, seed=2)
    _close(ctc_asr.log_mel(cfg, wav, "cpu"), jctc.log_mel(jcfg, wav))


def test_ctc_forward(ctc):
    cfg, jcfg, tp, jp = ctc
    mel = np.random.default_rng(0).normal(size=(2, 37, cfg.n_mels)).astype(np.float32)
    got = ctc_asr.forward(tp, cfg, torch.from_numpy(mel))
    assert got.shape == (2, 19, cfg.vocab + 1)
    _close(got, jctc.forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(mel)))


TEXTS = ["abad", "cab", "dbca", "bad cab"]


@pytest.fixture(scope="module")
def bank(ctc):
    cfg, jcfg, _, _ = ctc
    return (ctc_asr.make_training_bank(cfg, TEXTS, 3, 2, seed=1, device="cpu"),
            jctc.make_training_bank(jcfg, TEXTS, 3, 2, seed=1))


def test_ctc_training_bank(bank):
    got, ref = bank
    _close(got[0], ref[0])
    for g, r in zip(got[1:4], ref[1:4]):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert got[4] == ref[4]


def test_ctc_loss_against_optax(ctc, bank):
    """F.ctc_loss over the log-softmax with the lengths from the paddings,
    meaned, equals optax.ctc_loss on the logits and paddings, meaned."""
    cfg, _, tp, _ = ctc
    mel, mel_pad, labels, label_pad, _ = bank[0]
    logits = ctc_asr.forward(tp, cfg, torch.from_numpy(mel)).detach().numpy()
    lp = mel_pad[:, ::2][:, :logits.shape[1]]
    ref = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(lp), jnp.asarray(labels),
                         jnp.asarray(label_pad))
    got = ctc_asr.ctc_loss(tp, cfg, *(torch.from_numpy(a) for a in (mel, mel_pad, labels,
                                                                  label_pad)))
    _close(got, float(np.mean(np.asarray(ref))))


def test_ctc_train_step(ctc, bank):
    cfg, jcfg, tp, jp = ctc
    arrays = bank[0][:4]
    tx = optax.adam(optax.cosine_decay_schedule(LR, 10, 0.05))
    jparams = jax.tree.map(jnp.asarray, jp)
    jarr = [jnp.asarray(a) for a in arrays]
    new, _, ref_loss = jctc._train_step(jparams, tx.init(jparams), jcfg, tx, *jarr)

    def jloss(p):  # _train_step's loss
        logits = jctc.forward(p, jcfg, jarr[0])
        return jnp.mean(optax.ctc_loss(logits, jarr[1][:, ::2][:, :logits.shape[1]], jarr[2],
                                       jarr[3]))

    params = bridge.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tarr = [torch.from_numpy(a) for a in arrays]
    leaves = bridge.tree_leaves(params)
    grads = torch.autograd.grad(ctc_asr.ctc_loss(params, cfg, *tarr), leaves)
    g_got = _unflatten_like(params, [g.numpy() for g in grads])
    opt, sched = adam_cosine(leaves, LR, 10, 0.05)
    loss = ctc_asr.train_step(params, opt, sched, cfg, *tarr)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    _adam_step_close(_np(params), new, jp, g_got, jax.grad(jloss)(jparams), LR)


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return bridge.tree_map(lambda _: next(it), tree)


def test_greedy_decode():
    logits = np.random.default_rng(4).normal(size=(40, 28)).astype(np.float32)
    logits[5:9, 3] += 9  # a repeat that collapses
    for n in (None, 17, 40):
        assert ctc_asr.greedy_decode(logits, n) == jctc.greedy_decode(logits, n)


def test_transcribe(ctc, tmp_path):
    cfg, jcfg, tp, jp = ctc
    wav = sl.render("bad cab", 24000, speaker=2, seed=5)
    jparams = jax.tree.map(jnp.asarray, jp)
    got = ctc_asr.transcribe_array(tp, cfg, wav, 24000)
    assert got == jctc.transcribe_array(jparams, jcfg, wav, 24000)
    stereo = np.stack([wav, 0.5 * wav])
    assert ctc_asr.transcribe_array(tp, cfg, stereo, 24000) == \
        jctc.transcribe_array(jparams, jcfg, stereo, 24000)
    path = str(tmp_path / "u.wav")
    write_wav(path, wav[None], 24000)
    assert ctc_asr.make_ctc_transcriber(tp, cfg)(path) == \
        jctc.make_ctc_transcriber(jparams, jcfg)(path)


def test_train_ctc_runs_and_descends():
    cfg = ctc_asr.CTCConfig.tiny()
    params, curve = ctc_asr.train_ctc(cfg, TEXTS, n_speakers=2, n_render=2, steps=30,
                                      batch=4, lr=3e-3, log_every=10, device="cpu")
    assert len(curve) == 4 and np.isfinite(curve).all() and curve[-1] < curve[0]
    assert not any(t.requires_grad for t in bridge.tree_leaves(params))


# ------------------------------------------------------------ speaker ECAPA ----

SPK = dataclasses.replace(se.SpeakerTrainConfig.tiny(), n_speakers=3, utt_per_speaker=2)


@pytest.fixture(scope="module")
def spk():
    jcfg = jse.SpeakerTrainConfig(**dataclasses.asdict(SPK))
    ecfg = se._ecapa_cfg(SPK)
    assert dataclasses.asdict(ecfg) == dataclasses.asdict(jse._ecapa_cfg(jcfg))
    g = torch.Generator().manual_seed(0)
    params = ecapa.init_params(ecfg, g, "cpu")
    head = se.init_head(ecfg, SPK.n_speakers, g, "cpu")
    return jcfg, ecfg, params, head, se._render_bank(SPK, device="cpu"), jse._render_bank(jcfg)


def test_speaker_bank(spk):
    *_, got, ref = spk
    _close(got[0], ref[0])
    assert np.array_equal(got[1], ref[1])


def test_speaker_train_step(spk):
    from kalle_tpu.models.conditioning import ecapa as jecapa

    jcfg, ecfg, params, head, (mel, labels), _ = spk
    jecfg = jecapa.EcapaConfig(**dataclasses.asdict(ecfg))
    tx = optax.adam(optax.cosine_decay_schedule(LR, 10, 0.05))
    jph = (jax.tree.map(jnp.asarray, _np(params)), jax.tree.map(jnp.asarray, _np(head)))
    np_, nh, _, ref_loss = jse._step(*jph, tx.init(jph), jecfg, tx, jnp.asarray(mel),
                                     jnp.asarray(labels))

    def jloss(ph):  # _step's loss
        logits = jecapa.forward(ph[0], jecfg, jnp.asarray(mel)) @ ph[1]["w"] + ph[1]["b"]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)))

    p = bridge.tree_map(lambda t: t.clone().requires_grad_(True), params)
    h = bridge.tree_map(lambda t: t.clone().requires_grad_(True), head)
    leaves = bridge.tree_leaves(p) + bridge.tree_leaves(h)
    tmel, tlab = torch.from_numpy(mel), torch.from_numpy(labels)
    logits = ecapa.forward(p, ecfg, tmel) @ h["w"] + h["b"]
    grads = torch.autograd.grad(torch.nn.functional.cross_entropy(logits, tlab.long()), leaves)
    g_got = _unflatten_like((p, h), [g.numpy() for g in grads])
    opt, sched = adam_cosine(leaves, LR, 10, 0.05)
    loss = se.train_step(p, h, opt, sched, ecfg, tmel, tlab)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    _adam_step_close((_np(p), _np(h)), (np_, nh), jax.tree.map(np.asarray, jph), g_got,
                     jax.grad(jloss)(jph), LR)


def test_speaker_embed_and_margin(spk):
    jcfg, ecfg, params, _, _, _ = spk
    from kalle_tpu.models.conditioning import ecapa as jecapa

    jecfg = jecapa.EcapaConfig(**dataclasses.asdict(ecfg))
    jp = jax.tree.map(jnp.asarray, _np(params))
    wav = sl.render("a voice", 16000, speaker=1, seed=3)
    _close(se.embed_waveform(params, ecfg, SPK, wav, 16000),
           jse.embed_waveform(jp, jecfg, jcfg, wav, 16000))
    got, ref = se.margin(params, ecfg, SPK), jse.margin(jp, jecfg, jcfg)
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_train_speaker_embedder_runs():
    cfg = dataclasses.replace(SPK, steps=12, batch=4)
    params, ecfg, curve = se.train_speaker_embedder(cfg, device="cpu")
    assert len(curve) == 2 and np.isfinite(curve).all()
    assert not any(t.requires_grad for t in bridge.tree_leaves(params))
    assert se.embed_waveform(params, ecfg, cfg, np.zeros(4000, np.float32) + 0.1,
                             8000).shape == (ecfg.embd_dim,)


# --------------------------------------------------------------------- WER ----

REFS = {"u1": "the cat sat on the mat", "u2": "hello, world!", "u3": "你好世界 ok",
        "u4": "<unk> yes no", "u5": "a b c d e f"}
HYPS = {"u1": "the cat sat on mat", "u2": "hello word", "u3": "你好视界 ok ok",
        "u4": "<noise> yes", "u5": ""}


def _trn(tmp_path, name, rows):
    path = tmp_path / name
    path.write_text("".join(f"{k} {v}\n" for k, v in rows.items()), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("char_level", [True, False])
def test_compute_wer_equal(tmp_path, char_level):
    ref_p, hyp_p = _trn(tmp_path, "gt.txt", REFS), _trn(tmp_path, "asr.txt", HYPS)
    outs = []
    for mod in (wer, jwer):
        buf = io.StringIO()
        w, res = mod.compute_wer(mod.read_trn(ref_p), mod.read_trn(hyp_p), char_level=char_level,
                                 verbose=True, out=buf)
        outs.append((w, buf.getvalue(), [(r.utt, r.cor, r.sub, r.dele, r.ins) for r in res]))
    assert outs[0] == outs[1]


def test_score_pair_equal():
    for k in REFS:
        a = wer.score_pair(k, REFS[k], HYPS[k])
        b = jwer.score_pair(k, REFS[k], HYPS[k])
        assert (a.cor, a.sub, a.dele, a.ins, a.ops) == (b.cor, b.sub, b.dele, b.ins, b.ops)


def test_wer_cli_equal(tmp_path, capsys):
    ref_p, hyp_p = _trn(tmp_path, "gt.txt", REFS), _trn(tmp_path, "asr.txt", HYPS)
    outs = []
    for mod in (wer, jwer):
        assert mod.main(["--char=1", "--v=1", ref_p, hyp_p]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "WER" in outs[0]


# ----------------------------------------------------------------- harness ----

def _eval_dir(root, sr=16000):
    """gen / copysyn / prompt wavs of three utterances and a meta.lst (one
    row's wavs missing)."""
    os.makedirs(root, exist_ok=True)
    lines = []
    for i, text in enumerate(["abc", "bad cab", "dab!"]):
        prompt = os.path.join(root, f"p{i}.wav")
        write_wav(prompt, sl.render("ca", sr, speaker=i, seed=9)[None], sr)
        if i < 2:
            for kind, seed in (("gen", 1), ("copysyn", 2)):
                write_wav(os.path.join(root, f"u{i}---{kind}.wav"),
                          sl.render(text, sr, speaker=i, seed=seed)[None], sr)
        lines.append(f"u{i}|prompt text|{prompt}|{text}")
    meta = os.path.join(root, "meta.lst")
    with open(meta, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta


def _fake_transcriber(path):
    return os.path.basename(path).split("---")[0] + " says hi, there"


def _read_all(root):
    return {n: open(os.path.join(root, n), encoding="utf-8").read()
            for n in sorted(os.listdir(root)) if not n.endswith(".wav")}


@pytest.mark.parametrize("suffix", ["---gen.wav", "---copysyn.wav"])
def test_wer_pipeline_files_equal(tmp_path, suffix):
    out = {}
    for name, mod in (("port", harness), ("jax", jh)):
        root = str(tmp_path / name)
        meta = _eval_dir(root)
        w = mod.wer_pipeline("en", root, meta, transcriber=_fake_transcriber, gen_suffix=suffix)
        out[name] = (w, {k: v.replace(str(tmp_path / name), "") for k, v in
                         _read_all(root).items()})
    assert out["port"] == out["jax"]
    tag = "" if suffix == "---gen.wav" else "_copysyn"
    assert f"000000000_wer{tag}.txt" in out["port"][1]
    assert [i.utt for i in harness.read_meta_lst(str(tmp_path / "port" / "meta.lst"))] == \
        ["u0", "u1", "u2"]
    assert harness.clean_text("a,b! c.d") == jh.clean_text("a,b! c.d") == "a b c d"


def test_speaker_similarity_files_equal(tmp_path):
    def embed(path):  # a deterministic stand-in embedder
        a = np.frombuffer(open(path, "rb").read()[-256:], np.int16).astype(np.float32)
        return a[:64] + 1.0

    out = {}
    for name, mod in (("port", harness), ("jax", jh)):
        root = str(tmp_path / name)
        meta = mod.read_meta_lst(_eval_dir(root))
        mean = mod.speaker_similarity(root, meta, embed)
        files = _read_all(root)
        out[name] = (mean, json.loads(files["0000000_sim,json"]), files["0000000_sim.txt"])
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 2


def test_embedders_against_jax(tmp_path, spk):
    _, ecfg, params, _, _, _ = spk
    from kalle_tpu.models.conditioning import ecapa as jecapa

    path = str(tmp_path / "x.wav")
    a, b = (sl.render("hello", 22050, speaker=s, seed=1) for s in (3, 4))
    n = min(len(a), len(b))
    write_wav(path, np.stack([a[:n], b[:n]]), 22050)
    _close(harness.make_spectral_embedder(device="cpu")(path),
           jh.make_spectral_embedder()(path))
    ecfg80 = dataclasses.replace(ecfg, in_channels=80)
    p80 = ecapa.init_params(ecfg80, torch.Generator().manual_seed(5), "cpu")
    _close(harness.make_ecapa_embedder(p80, ecfg80)(path),
           jh.make_ecapa_embedder(jax.tree.map(jnp.asarray, _np(p80)),
                                  jecapa.EcapaConfig(**dataclasses.asdict(ecfg80)))(path))


@pytest.mark.parametrize("lang", ["en", "zh", "fr"])
def test_no_builtin_transcriber(tmp_path, lang):
    with pytest.raises(ValueError):
        harness.make_transcriber(lang)
    meta = harness.read_meta_lst(_eval_dir(str(tmp_path)))
    with pytest.raises(ValueError):
        harness.run_asr(lang, str(tmp_path), meta)
