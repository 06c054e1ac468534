"""Per-rank data and the Trainer's parallel wiring in the port
(parallel/multihost.py, data/datasets.py, train/trainer.py) and the
multi-process dryrun (`python -m kalle_tpu_torch.parallel.dryrun`), on the
CPU (counterparts of tests/test_multihost.py and
tests/test_multihost_dryrun.py):

  * OfflineLatentDataset(shard_index, shard_count) keeps JAX's round-robin
    rows: disjoint, complete, the same lines as the JAX dataset's shards;
  * Trainer.fit on 2 gloo ranks (one spawn): the mesh from TrainConfig
    (dp -1 takes both ranks), each rank on its own data shard, every rank
    with the same metrics, only the main process writing metrics; the
    checkpoint holds full tensors, and a single-process Trainer resumes
    from it with the gathered params (bit for bit);
  * the dryrun exits 0 with a passing JSON verdict (loss, global and leaf
    gradient norms within 2e-4 relative of one process), and 1 when a
    rank is fed the wrong rows.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from kalle_tpu.data import datasets as jdatasets
from kalle_tpu.data import tokens as jtokens
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.data import datasets, tokens
from kalle_tpu_torch.parallel import multihost
from kalle_tpu_torch.parallel.dryrun import spawn
from kalle_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dataset_shards_partition_as_jax():
    rows = [{"id": f"u{i}", "caption": f"text {i}", "vae": f"/nope/{i}.npy"}
            for i in range(10)]
    tok, jtok = tokens.build_tokenizer(), jtokens.build_tokenizer()
    shards = [datasets.OfflineLatentDataset(rows, tok, shard_index=i, shard_count=4)
              for i in range(4)]
    ids = [[r["id"] for r in s.lines] for s in shards]
    flat = [u for s in ids for u in s]
    assert sorted(flat) == sorted(r["id"] for r in rows) and len(set(flat)) == len(flat)
    assert [len(s) for s in shards] == [3, 3, 2, 2]  # round-robin
    for i, s in enumerate(shards):
        assert s.lines == jdatasets.OfflineLatentDataset(rows, jtok, shard_index=i,
                                                         shard_count=4).lines
    assert multihost.process_info() == (0, 1) and multihost.is_main_process()


def _experiment(root: Path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        t = int(rng.integers(5, 14))
        arr = np.concatenate([rng.normal(size=(1, 8, t)), rng.uniform(0.5, 1.5, (1, 8, t))], 1)
        path = root / f"lat{i}.npy"
        np.save(path, arr.astype(np.float32))
        rows.append({"id": f"u{i}", "caption": f"some text {i}", "vae": str(path)})
    meta = root / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    return config.ExperimentConfig(
        exp_dir=str(root / "exp"), model=config.LlasaConfig.tiny(head_variant="stableaudio"),
        train=config.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=20, log_interval=1,
                                 save_interval=1000, seed=7),
        data=config.DataConfig(meta_path=str(meta), latent_kind="stableaudio", batch_size=2,
                               use_dynamic=False, num_workers=1, length_buckets=(32,),
                               max_length=32))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    exp = _experiment(tmp_path_factory.mktemp("mh"))
    return exp, spawn(R.trainer, 2, exp, timeout_s=400)


def test_trainer_shards_data_and_agrees(trained):
    _, res = trained
    assert [r["shard"] for r in res] == [(0, 2), (1, 2)]
    assert all(r["mesh"] == {"dp": 2, "tp": 1} for r in res)
    assert [r["main"] for r in res] == [True, False]
    assert [r["writes_metrics"] for r in res] == [True, False]
    hist = res[0]["history"]
    assert len(hist) == 2 and all(np.isfinite(h["total_loss"]) for h in hist)
    for r in res[1:]:
        assert [{k: v for k, v in h.items() if k != "steps_per_s"} for h in r["history"]] == \
            [{k: v for k, v in h.items() if k != "steps_per_s"} for h in hist]


def test_checkpoint_restores_at_another_layout(trained):
    """The dp 2 run's checkpoint holds full tensors: a single-process
    Trainer resumes from it at step 2 with exactly the gathered params."""
    exp, res = trained
    tr = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    assert tr.mesh is None and tr.start_step == 2
    got = bridge.tree_leaves(bridge.params_to_numpy(tr.state.params))
    for a, b in zip(got, bridge.tree_leaves(res[0]["params"])):
        np.testing.assert_array_equal(a, b)
    assert os.path.isfile(os.path.join(exp.output_dir, "torch", "step_2.pt"))


def _dryrun(*args):
    return subprocess.run([sys.executable, "-m", "kalle_tpu_torch.parallel.dryrun", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=400)


def test_dryrun_passes():
    out = _dryrun()
    assert out.returncode == 0, out.stderr[-2000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["ok"] and verdict["processes"] == 2 and not verdict["planted_mismatch"]
    for r in verdict["ranks"]:
        assert r["dp"] == 2 and r["ok"]
        assert max(r["rel_dloss"], r["rel_dgrad_norm"], r["max_rel_dleaf_norm"]) < 2e-4


def test_dryrun_catches_a_planted_mismatch():
    out = _dryrun("--plant-mismatch")
    assert out.returncode == 1, out.stderr[-2000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert not verdict["ok"] and verdict["planted_mismatch"]
