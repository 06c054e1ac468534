"""The port's optimizer, train_step, data pipeline, config loader and
checkpoints against the JAX package (CPU, tiny configs, f32):

  * the warmup-cosine schedule and the global-norm clip against optax;
  * train_step against kalle_tpu.train.step.train_step over three steps
    (stableaudio head: no input noise, so both draw nothing at random), with
    clipping and the grad-norm metric on. Losses at rtol 1e-4. Params at
    rtol 1e-4 / atol 1e-2 * lr: an AdamW update is about lr * g / (|g| + eps),
    so a gradient within a few eps (1e-8) of zero that differs in its last
    digits between the frameworks moves its weight by a share of lr;
  * gradient accumulation: A=2 equals one batch holding both microbatches
    (equal mask counts, so the mean of the two losses is the big batch's
    loss), and equals JAX's A=2 step;
  * collate, stack_microbatches, OfflineLatentDataset and PrefetchLoader
    (one worker) give JAX's arrays bit for bit;
  * load_experiment_config reads every YAML in configs/ as JAX does;
  * a checkpoint resume reproduces the uninterrupted run bit for bit, as
    tests/test_resume_determinism.py does for JAX.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kalle_tpu.core import checkpoint as jckpt
from kalle_tpu.core import config as jconfig
from kalle_tpu.data import collate as jcollate
from kalle_tpu.data import datasets as jdatasets
from kalle_tpu.data import tokens as jtokens
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.train import optim as joptim
from kalle_tpu.train import step as jstep
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import checkpoint, config
from kalle_tpu_torch.data import collate, datasets, tokens
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.train import optim, step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _items(shapes, latent_dim=8, dist_dim=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n_ids, n_frames in shapes:
        dist = np.concatenate([rng.normal(size=(n_frames, dist_dim // 2)),
                               rng.uniform(0.5, 1.5, (n_frames, dist_dim // 2))], -1)
        out.append(collate.Item(
            input_ids=rng.integers(0, 300, n_ids).astype(np.int32),
            audio_latents=rng.normal(size=(n_frames, latent_dim)).astype(np.float32),
            audio_distribution=dist.astype(np.float32)))
    return out


def _j_items(items):
    return [jcollate.Item(input_ids=i.input_ids, audio_latents=i.audio_latents,
                          audio_distribution=i.audio_distribution) for i in items]


def _arrays(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in _arrays(batch).items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in _arrays(batch).items()}


# --------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 3, 10), (5e-5, 1000, 200000), (2e-4, 0, 5)])
def test_schedule_matches_optax(lr, warmup, total):
    tcfg = config.TrainConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    ref = joptim.cosine_warmup_schedule(jconfig.TrainConfig(lr=lr, warmup_steps=warmup,
                                                            total_steps=total))
    steps = list(range(0, 12)) + [warmup - 1, warmup, warmup + 1, total - 1, total, total + 7]
    # optax evaluates in f32 as end + (init - end) * (1 - count / warmup), which
    # cancels: the two agree to f32 rounding of the peak
    for s in steps:
        np.testing.assert_allclose(optim.lr_at(tcfg, max(s, 0)), float(ref(max(s, 0))),
                                   rtol=1e-6, atol=1e-6 * lr, err_msg=f"step {s}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.global_norm(got)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    optim.clip_by_global_norm_(got, max_norm, norm)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- train_step --

def _setup(head="stableaudio", **tkw):
    jcfg = jconfig.LlasaConfig.tiny(head_variant=head)
    jp = jllasa.init_params(jcfg, jax.random.key(3))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, config.LlasaConfig.tiny(head_variant=head), params


def _compare_params(port, jax_params, **tol):
    ref = jax.tree.map(np.asarray, jax_params)  # (sorts dict keys)
    got = bridge.tree_leaves(bridge.params_to_numpy(port))
    ref_flat = dict(zip(_paths(ref), bridge.tree_leaves(ref)))
    for path, g in zip(_paths(port), got):
        np.testing.assert_allclose(g, ref_flat[path], err_msg=path, **tol)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    return [prefix]


def test_train_step_matches_jax_three_steps():
    jcfg, jp, cfg, params = _setup()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, max_grad_norm=1.0, log_grad_norm=True)
    jt, tcfg = jconfig.TrainConfig(**kw), config.TrainConfig(**kw)
    tx = joptim.make_optimizer(jt)
    jstate = jstep.make_train_state(jp, tx)
    state = step.make_train_state(params, tcfg)
    for i in range(3):
        b = collate.collate(_items(((6, 10), (9, 14)), seed=10 + i), 0, buckets=(32,))
        jstate, jm = jstep.train_step(jstate, jcfg, jt, tx, _to_jax(b), jax.random.key(0))
        m = step.train_step(state, cfg, tcfg, _to_torch(b))
        for k in ("total_loss", "audio_loss", "end_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 3
    _compare_params(state.params, jstate.params, rtol=1e-4, atol=1e-2 * jt.lr)


def test_gradient_accumulation_equals_one_batch_and_jax():
    jcfg, jp, cfg, params = _setup()
    kw = dict(lr=1e-3, scheduler="constant")
    one = config.TrainConfig(**kw)
    two = config.TrainConfig(gradient_accumulation_steps=2, **kw)
    # equal target and end counts in the two microbatches (24 frames, 2 rows)
    mb = [collate.collate(_items(s, seed=20 + i), 0, buckets=(32,))
          for i, s in enumerate((((6, 10), (9, 14)), ((7, 12), (5, 12))))]
    stacked = collate.stack_microbatches([_arrays(b) for b in mb], 0)
    joined = {k: np.concatenate([b[k] for b in mb]) for k in _arrays(mb[0])}

    s2 = step.make_train_state(bridge.tree_map(torch.clone, params), two)
    m2 = step.train_step(s2, cfg, two, _to_torch(stacked))
    s1 = step.make_train_state(bridge.tree_map(torch.clone, params), one)
    m1 = step.train_step(s1, cfg, one, _to_torch(joined))
    np.testing.assert_allclose(float(m2["total_loss"]), float(m1["total_loss"]), rtol=1e-5)
    for a, b in zip(bridge.tree_leaves(s2.params), bridge.tree_leaves(s1.params)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-4, atol=1e-8)

    jt = jconfig.TrainConfig(gradient_accumulation_steps=2, **kw)
    tx = joptim.make_optimizer(jt)
    jstate, jm = jstep.train_step(jstep.make_train_state(jp, tx), jcfg, jt, tx,
                                  _to_jax(stacked), jax.random.key(0))
    np.testing.assert_allclose(float(m2["total_loss"]), float(jm["total_loss"]), rtol=1e-4)
    _compare_params(s2.params, jstate.params, rtol=1e-4, atol=1e-2 * jt.lr)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Params, AdamW state, the schedule and the per-step noise generators
    all resume: bit for bit on the CPU (sigma head: noise drawn every step)."""
    _, _, cfg, params = _setup(head="sigma")
    tcfg = config.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    batches = [_to_torch(collate.collate(_items(((5, 8), (5, 8)), dist_dim=8, seed=s), 0,
                                         buckets=(16,))) for s in range(4)]
    state = step.make_train_state(bridge.tree_map(torch.clone, params), tcfg)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    for i, b in enumerate(batches):
        step.train_step(state, cfg, tcfg, b)
        if i == 1:
            mgr.save(state.step, state, wait=True)
    template = step.make_train_state(bridge.tree_map(torch.clone, params), tcfg)
    restored, at = mgr.restore(template)
    assert at == 2 and restored.step == 2
    for b in batches[2:]:
        step.train_step(restored, cfg, tcfg, b)
    for a, c in zip(bridge.tree_leaves(state.params), bridge.tree_leaves(restored.params)):
        assert torch.equal(a, c)


def test_checkpoint_keeps_the_newest(tmp_path):
    _, _, _, params = _setup()
    state = step.make_train_state(params, config.TrainConfig())
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    for s in range(1, 8):
        mgr.save(s, state)
    assert mgr.steps() == [3, 4, 5, 6, 7] and mgr.latest_step() == 7


def test_params_npz_round_trips_with_jax(tmp_path):
    _, jp, _, params = _setup()
    checkpoint.save_params_npz(str(tmp_path / "port.npz"), params)
    back = jckpt.load_params_npz(str(tmp_path / "port.npz"))
    jckpt.save_params_npz(str(tmp_path / "jax.npz"), jp)
    ours = checkpoint.load_params_npz(str(tmp_path / "jax.npz"))
    for tree in (back, ours):
        _compare_params(params, tree, rtol=0, atol=0)


# --------------------------------------------------------------- data -------

def test_collate_and_stacking_match_jax():
    items = _items(((6, 10), (9, 21), (3, 4)), seed=1)
    for buckets in (None, (16, 32, 64)):
        got = collate.collate(items, 7, buckets=buckets)
        ref = jcollate.collate(_j_items(items), 7, buckets=buckets)
        assert got.keys() == ref.keys()
        for k in _arrays(ref):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    short = collate.collate(items[:1], 7)
    long = collate.collate(items[1:], 7)
    got = collate.stack_microbatches([_arrays(short), _arrays(long)], 7)
    ref = jcollate.stack_microbatches([_arrays(short), _arrays(long)], 7)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    got = collate.pad_batch_rows(_arrays(long), 4, 7)
    ref = jcollate.pad_batch_rows(_arrays(long), 4, 7)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _latent_dir(tmp_path, kind):
    rng = np.random.default_rng(5)
    rows = []
    for i in range(7):
        t = int(rng.integers(4, 12))
        arr = (rng.normal(size=(1, t, 8)) if kind == "sigma"
               else np.concatenate([rng.normal(size=(1, 8, t)),
                                    rng.uniform(0.5, 1.5, (1, 8, t))], 1))
        path = str(tmp_path / f"{kind}{i}.npy")
        np.save(path, arr.astype(np.float32))
        rows.append({"id": f"u{i}", "caption": f"caption number {i}",
                     ("vae" if kind == "sigma" else "vae_latent_path"): path})
    rows.append({"id": "bad", "caption": "missing", "vae": str(tmp_path / "nope.npy")})
    meta = tmp_path / f"{kind}.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    return str(meta)


@pytest.mark.parametrize("kind", ["sigma", "stableaudio"])
def test_dataset_and_loader_match_jax(tmp_path, kind):
    meta = _latent_dir(tmp_path, kind)
    ours = datasets.OfflineLatentDataset(meta, tokens.build_tokenizer(), latent_kind=kind,
                                         seed=3)
    ref = jdatasets.OfflineLatentDataset(meta, jtokens.build_tokenizer(), latent_kind=kind,
                                         seed=3)
    ours.set_epoch(1)
    ref.set_epoch(1)
    assert ours.shuffled_indices() == ref.shuffled_indices()
    for i in range(len(ref)):  # the missing file resamples a row, the same one
        a, b = ours[i], ref[i]
        for f in ("input_ids", "audio_latents", "audio_distribution"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.raw_text == b.raw_text

    kw = dict(max_token_length=40, batch_size=3, buckets=(16, 32), num_workers=1)
    got = list(datasets.PrefetchLoader(
        datasets.OfflineLatentDataset(meta, tokens.build_tokenizer(), latent_kind=kind,
                                      seed=3), 256, **kw).epoch_iter(0))
    want = list(jdatasets.PrefetchLoader(
        jdatasets.OfflineLatentDataset(meta, jtokens.build_tokenizer(), latent_kind=kind,
                                       seed=3), 256, **kw).epoch_iter(0))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for k in _arrays(b):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prompt_ids_match_jax():
    ours, ref = tokens.build_tokenizer(), jtokens.build_tokenizer()
    text = "a caption, with ünïcode"
    assert tokens.build_prompt_ids(ours, text) == jtokens.build_prompt_ids(ref, text)
    assert ours.special == tokens.SpecialIds(*dataclasses.astuple(ref.special))


# --------------------------------------------------------------- config -----

def _common(port, ref, path=""):
    """Every field the port's config has, equal to JAX's."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _common(a, b, f"{path}{f.name}.")
        else:
            assert a == b, f"{path}{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_experiment_config_matches_jax(path):
    _common(config.load_experiment_config(str(path)),
            jconfig.load_experiment_config(str(path)))
