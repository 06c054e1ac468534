"""The port's SFT and mel-VAE datasets, CFG mask dropout and the infinite
prefetch stream (kalle_tpu_torch/data/) against the JAX package's copies
of them, on the CPU. All host-side numpy: the same seeds give the same
rows, draws and batches, compared exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from kalle_tpu.data import collate as jcollate
from kalle_tpu.data import data_pool as jpool
from kalle_tpu.data import datasets as jdatasets
from kalle_tpu.data import tokens as jtokens
from kalle_tpu_torch.data import collate, data_pool, datasets, tokens
from kalle_tpu_torch.utils.audio import write_wav


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rows(root, prefix, n, rng):
    rows = []
    for i in range(n):
        path = root / f"{prefix}{i}.npy"
        np.save(path, rng.normal(size=(1, 3 + i % 5, 8)).astype(np.float32))
        rows.append({"id": f"{prefix}{i}", "caption": f"{prefix} caption {i}",
                     "vae": str(path)})
    return rows


def _assert_items_equal(got, ref):
    np.testing.assert_array_equal(got.input_ids, ref.input_ids)
    np.testing.assert_array_equal(got.audio_latents, ref.audio_latents)
    np.testing.assert_array_equal(got.audio_distribution, ref.audio_distribution)
    assert got.raw_text == ref.raw_text
    assert os.path.basename(got.speech_path) == os.path.basename(ref.speech_path)


def test_sft_mix_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    base, sft = _rows(tmp_path, "base", 9, rng), _rows(tmp_path, "sft", 4, rng)
    meta = tmp_path / "sft.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in sft))
    got = datasets.SftMixDataset(base, str(meta), tokens.build_tokenizer(), seed=5)
    ref = jdatasets.SftMixDataset(base, str(meta), jtokens.build_tokenizer(), seed=5)
    seen = set()
    for epoch in range(3):
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert got.lines == ref.lines and len(got) == 8
        assert sum(r["id"].startswith("sft") for r in got.lines) == 4
        seen.add(tuple(r["id"] for r in got.lines))
        assert got.shuffled_indices() == ref.shuffled_indices()
        for i in (0, 5):
            _assert_items_equal(got[i], ref[i])
    assert len(seen) == 3  # each epoch samples and shuffles anew


def _wavs(root, n):
    rng = np.random.default_rng(1)
    rows = []
    for i in range(n):
        path = str(root / f"utt{i}.wav")
        write_wav(path, 0.2 * rng.normal(size=(2, 4000 + 800 * i)).astype(np.float32), 24000)
        rows.append({"caption": f"utterance {i}", "speech": path})
    return rows


def _stub_encoder(calls):
    """(1, 1, T) f32 -> (1, 2*4, T // 160) mean||log_scale, a fixed function."""
    def encode(wav):
        calls.append(wav.shape)
        frames = wav[0, 0, : wav.shape[-1] // 160 * 160].reshape(-1, 160)
        mean = np.stack([frames.mean(1) * (k + 1) for k in range(4)])
        logs = np.stack([np.log(frames.std(1) + 0.1) - k for k in range(4)])
        return np.concatenate([mean, logs])[None].astype(np.float32)
    return encode


def test_melvae_cache_dataset_matches_jax(tmp_path):
    out = {}
    for name, mod, tok in (("port", datasets, tokens), ("jax", jdatasets, jtokens)):
        root = tmp_path / name
        root.mkdir()
        calls = []
        ds = mod.MelVAECacheDataset(_wavs(root, 3), tok.build_tokenizer(),
                                    encode_fn=_stub_encoder(calls), seed=2)
        first = [ds[i] for i in range(3)]
        again = ds[1]  # read from the cache: no encode
        out[name] = (first + [again], len(calls),
                     [np.load(root / f"utt{i}.melvae.npy") for i in range(3)],
                     sorted(p.name for p in root.iterdir()))
    (got, n_got, cache_got, files_got), (ref, n_ref, cache_ref, files_ref) = (
        out["port"], out["jax"])
    assert n_got == n_ref == 3  # one encode a wav, the fourth read hit the cache
    assert files_got == files_ref and not [f for f in files_got if "tmp" in f]
    for a, b in zip(cache_got, cache_ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, ref):
        _assert_items_equal(a, b)
    # (T', mean||log_scale): 4000 samples at 24 kHz -> 2666 at 16 kHz -> 16 frames
    assert got[0].audio_distribution.shape == (16, 8) and got[0].audio_latents.shape == (16, 4)


def test_cfg_mask_dropout_matches_jax():
    rng = np.random.default_rng(4)
    batch = {"audio_mask": rng.random((3, 40)) < 0.7, "ids_mask": rng.random((3, 40)) < 0.3,
             "input_ids": rng.integers(0, 9, (3, 40))}
    got = collate.cfg_mask_dropout(batch, 0.3, np.random.default_rng(9))
    ref = jcollate.cfg_mask_dropout(batch, 0.3, np.random.default_rng(9))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["audio_mask"].sum() < batch["audio_mask"].sum()
    assert not (got["audio_mask"] & ~batch["audio_mask"]).any()


def _pool_items(mod, n=7):
    rng = np.random.default_rng(5)
    return [mod.Item(input_ids=rng.integers(0, 300, 3 + i % 4).astype(np.int32),
                     audio_latents=rng.normal(size=(4 + i, 8)).astype(np.float32),
                     audio_distribution=rng.normal(size=(4 + i, 8)).astype(np.float32))
            for i in range(n)]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("dynamic", [False, True])
def test_infinite_pool_batches_match_jax(shuffle, dynamic):
    """One worker: the stream is deterministic, so both packages' first
    batches are the same arrays."""
    out = {}
    for name, pool_mod, col in (("port", data_pool, collate), ("jax", jpool, jcollate)):
        pool = pool_mod.DataPrefetchPool(_pool_items(col), max_size=16, num_workers=1,
                                         shuffle=shuffle, seed=3).start()
        fn = lambda b, col=col: col.collate(b, 0)  # noqa: E731
        it = (pool_mod.DynamicPrefetchBatchIterator(pool, 40, collate_fn=fn) if dynamic
              else pool_mod.PrefetchDataIterator(pool, 3, collate_fn=fn))
        out[name] = [next(it) for _ in range(4)]
        pool.stop()
    for got, ref in zip(out["port"], out["jax"]):
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pool_stop_leaves_no_worker():
    pool = data_pool.DataPrefetchPool(list(range(5)), max_size=4, num_workers=2).start()
    assert sorted({pool.get() for _ in range(12)}) <= list(range(5))
    pool.stop()
    assert pool._threads == [] and pool.qsize() == 0
