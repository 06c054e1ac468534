"""The port's CheckpointManager (kalle_tpu_torch/core/checkpoint.py) with
the JAX package's interface: `max_to_keep`, `restore(step=)`, `close()`
and an asynchronous `save(wait=False)` (host copy on the caller's thread,
the write and the pruning on one background thread). CPU, tiny config.

A run that saves without waiting and goes on training (changing the
state the save copied) resumes from that checkpoint to the same params
and AdamW state as the uninterrupted run, bit for bit; no writer thread
is left once `close()` returns; a failed write is raised by the next call
that waits for it; Trainer.fit leaves no writer running.
"""
import json
import threading

import numpy as np
import pytest
import torch

from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import checkpoint, config
from kalle_tpu_torch.data import collate, tokens
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.train import step
from kalle_tpu_torch.train.trainer import Trainer

CFG = config.LlasaConfig.tiny(head_variant="stableaudio")
TCFG = config.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=100)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _writers():
    return [t for t in threading.enumerate() if t.name.startswith("checkpoint-")]


def _state():
    params = llasa.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return step.make_train_state(params, TCFG)


def _batch(seed):
    rng = np.random.default_rng(seed)
    items = []
    for n_ids, n_frames in ((5, 8), (4, 9)):
        dist = np.concatenate([rng.normal(size=(n_frames, 8)),
                               rng.uniform(0.5, 1.5, (n_frames, 8))], -1)
        items.append(collate.Item(
            input_ids=rng.integers(0, 300, n_ids).astype(np.int32),
            audio_latents=rng.normal(size=(n_frames, 8)).astype(np.float32),
            audio_distribution=dist.astype(np.float32)))
    b = collate.collate(items, 0, buckets=(16,))
    return {k: torch.from_numpy(v) for k, v in b.items() if isinstance(v, np.ndarray)}


def _assert_states_equal(a, b):
    for x, y in zip(bridge.tree_leaves(a.params), bridge.tree_leaves(b.params)):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict() and a.step == b.step


def test_max_to_keep_restore_step_and_close(tmp_path):
    state = _state()
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    saved = {}
    for s in range(1, 5):
        step.train_step(state, CFG, TCFG, _batch(s))
        saved[s] = [p.detach().clone() for p in bridge.tree_leaves(state.params)]
        mgr.save(s, state)
    mgr.close()
    assert not _writers()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    for s in (3, 4):
        restored, at = mgr.restore(_state(), step=s)
        assert at == s and restored.step == s
        for p, ref in zip(bridge.tree_leaves(restored.params), saved[s]):
            assert torch.equal(p, ref)
    restored, at = mgr.restore(_state())
    assert at == 4
    # a step at or below the newest is not saved again (orbax's should_save)
    mgr.save(3, _state(), wait=True)
    assert mgr.steps() == [3, 4]
    again = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert again.restore(_state(), step=3)[1] == 3


def test_async_save_then_resume_matches_uninterrupted(tmp_path):
    """The save copies the state when it is called: the steps that follow
    while the writer runs do not reach the file."""
    batches = [_batch(10 + i) for i in range(4)]
    straight = _state()
    for b in batches:
        step.train_step(straight, CFG, TCFG, b)

    run = _state()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    for i, b in enumerate(batches[:3]):
        step.train_step(run, CFG, TCFG, b)
        if i == 1:
            mgr.save(run.step, run, wait=False)  # step 3 runs while it is written
    mgr.close()
    assert mgr.write_s > 0
    resumed, at = checkpoint.CheckpointManager(str(tmp_path / "ckpt")).restore(_state())
    assert at == 2
    for b in batches[2:]:
        step.train_step(resumed, CFG, TCFG, b)
    _assert_states_equal(resumed, straight)


def test_writer_error_is_raised_and_no_thread_is_left(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    state = _state()
    mgr.save(1, state, wait=True)
    (tmp_path / "ckpt" / "step_2.pt.tmp").mkdir()  # the writer cannot write its temp file
    mgr.save(2, state)
    with pytest.raises((OSError, RuntimeError), match="[Ii]s a directory"):
        mgr.close()
    assert not _writers()
    mgr.close()  # the error was reported once; the manager stays usable
    assert mgr.steps() == [1]


def test_fit_leaves_no_writer_running(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        path = tmp_path / f"lat{i}.npy"
        np.save(path, rng.normal(size=(1, 6 + i, 8)).astype(np.float32))
        rows.append({"id": f"u{i}", "caption": f"text {i}", "vae": str(path)})
    meta = tmp_path / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    exp = config.ExperimentConfig(
        exp_dir=str(tmp_path / "exp"), model=config.LlasaConfig.tiny(),
        train=config.TrainConfig(lr=1e-3, warmup_steps=1, log_interval=1, save_interval=1),
        data=config.DataConfig(meta_path=str(meta), batch_size=2, use_dynamic=False,
                               num_workers=1, length_buckets=(32,), max_length=32))
    tr = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    tr.ckpt.max_to_keep = 2
    tr.fit(max_steps=3)
    assert not _writers()
    assert tr.ckpt.steps() == [2, 3]
