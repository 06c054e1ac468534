"""Host-side datasets: jsonl metadata + precomputed-latent .npy files (copy
of kalle_tpu/data/datasets.py: `OfflineLatentDataset`, the SFT mix
`SftMixDataset`, the mel-VAE cache `MelVAECacheDataset` and
`PrefetchLoader`).

Rows carry a caption (`AudioSetCaps` / `caption` / `text`), `speech`, and
`vae` (sigma: a (1, T, 64) .npy of means) or `vae_latent_path`
(stableaudio: a (1, 128, T) mean||scale .npy, reparam-sampled per item). A
row that fails (missing file, NaN/Inf, too long) resamples a random index.
`PrefetchLoader` packs items with the token-budget batcher into static
length buckets on a producer thread.
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils.audio import read_wav, resample_linear
from .collate import DynamicBatchGenerator, Item, collate
from .data_pool import finite_iter, put_until_stopped
from .tokens import build_prompt_ids


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def vae_sample(mean: np.ndarray, scale: np.ndarray, rng: np.random.Generator):
    """Reparameterised sample + KL. As in the reference, `scale` is used
    directly as the stdev (no softplus)."""
    stdev = scale
    latents = rng.standard_normal(mean.shape, dtype=np.float32) * stdev + mean
    var = stdev * stdev
    logvar = np.log(np.maximum(var, 1e-12))
    kl = (mean * mean + var - logvar - 1).sum(1).mean()
    return latents, kl


def load_sigma_latent(path: str) -> np.ndarray:
    """(1, T, d) .npy -> (T, d) f32 means (the model adds the noise)."""
    arr = np.load(path)
    if arr.ndim == 3:
        arr = arr[0]
    return arr.astype(np.float32)


def load_stableaudio_latent(path: str, rng: np.random.Generator):
    """(1, 2d, T) mean||scale .npy -> (dist (T, 2d), sampled latents (T, d))."""
    arr = np.load(path)
    if arr.ndim == 2:
        arr = arr[None]
    arr = arr.astype(np.float32)
    d2 = arr.shape[1]
    mean, scale = arr[:, : d2 // 2], arr[:, d2 // 2:]
    latents, _ = vae_sample(mean, scale, rng)
    return np.transpose(arr[0]), np.transpose(latents[0])


class OfflineLatentDataset:
    """jsonl-of-{caption, vae, speech} dataset with retry-on-error."""

    CAPTION_KEYS = ("AudioSetCaps", "caption", "text")

    def __init__(self, meta_path_or_lines, tokenizer, latent_kind: str = "sigma",
                 seed: int = 0, max_length: int = 2048, shard_index: int = 0,
                 shard_count: int = 1):
        if isinstance(meta_path_or_lines, str):
            self.lines = read_jsonl(meta_path_or_lines)
        else:
            self.lines = list(meta_path_or_lines)
        if shard_count > 1:  # a dp rank reads its own rows
            self.lines = self.lines[shard_index::shard_count]
        self.tokenizer = tokenizer
        self.latent_kind = latent_kind
        self.max_length = max_length
        self.rng = np.random.default_rng(seed)
        self.py_rng = random.Random(seed)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.lines)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.py_rng.seed(epoch)

    def _caption(self, row: dict) -> str:
        for k in self.CAPTION_KEYS:
            if k in row and row[k]:
                return str(row[k])
        raise KeyError(f"no caption key in {list(row)}")

    def _latents(self, row: dict):
        """row -> (latents (T, d), distribution (T, d or 2d))."""
        vae_path = row["vae"] if "vae" in row else row["vae_latent_path"]
        if self.latent_kind == "sigma":
            lat = load_sigma_latent(vae_path)
            return lat, lat.copy()
        dist, lat = load_stableaudio_latent(vae_path, self.rng)
        return lat, dist

    def __getitem__(self, idx: int) -> Item:
        last_err: Optional[Exception] = None
        for _attempt in range(64):
            try:
                row = self.lines[idx]
                if not row:
                    raise ValueError("empty row")
                text = self._caption(row)
                lat, dist = self._latents(row)
                ids = np.asarray(build_prompt_ids(self.tokenizer, text), np.int32)
                if not (np.isfinite(lat).all() and np.isfinite(dist).all()):
                    raise ValueError("NaN/Inf in latents")
                if ids.shape[0] + lat.shape[0] > self.max_length:
                    raise ValueError("sequence too long")
                return Item(input_ids=ids, audio_latents=lat, audio_distribution=dist,
                            raw_text=text, speech_path=str(row.get("speech", "")))
            except (OSError, EOFError, KeyError, IndexError, ValueError) as e:  # resample a random row
                idx = self.py_rng.randint(0, len(self.lines) - 1)
                last_err = e
        raise RuntimeError(f"dataset failed 64 retries: {last_err}")

    def shuffled_indices(self) -> List[int]:
        idxs = list(range(len(self.lines)))
        self.py_rng.shuffle(idxs)
        return idxs


class SftMixDataset(OfflineLatentDataset):
    """SFT mixing: each epoch trains on the SFT rows plus an equal-size
    random sample of the base rows, shuffled together (the reference's
    `sft_lst + random.sample(base_lst, len(sft_lst))`), drawn from the
    epoch-seeded `py_rng` as the JAX package draws them."""

    def __init__(self, base_meta, sft_meta, tokenizer, **kw):
        self.base_lines = read_jsonl(base_meta) if isinstance(base_meta, str) else list(base_meta)
        self.sft_lines = read_jsonl(sft_meta) if isinstance(sft_meta, str) else list(sft_meta)
        super().__init__(self.sft_lines, tokenizer, **kw)
        self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        if hasattr(self, "base_lines"):
            n = min(len(self.sft_lines), len(self.base_lines))
            self.lines = self.sft_lines + self.py_rng.sample(self.base_lines, n)
            self.py_rng.shuffle(self.lines)


class MelVAECacheDataset(OfflineLatentDataset):
    """mel-VAE latents cached next to the wav as `{speech_stem}.melvae.npy`,
    (1, 2*dim, T) mean||log_scale. A cached file is loaded; otherwise the
    row's wav (mixed to mono, resampled to `target_sr`) goes through the
    injected `encode_fn` ((1, 1, T) f32 -> (1, 2*dim, T')) and the result
    is written back atomically (a temporary file, then a rename), so the
    first epoch pays the encode once. Each item's latents are a
    reparameterised draw mean + exp(log_scale) * N(0, 1) from the
    dataset's numpy generator; its distribution is mean||log_scale."""

    def __init__(self, meta_path_or_lines, tokenizer,
                 encode_fn: Callable[[np.ndarray], np.ndarray],
                 target_sr: int = 16000, write_cache: bool = True, **kw):
        kw.setdefault("latent_kind", "melvae")
        super().__init__(meta_path_or_lines, tokenizer, **kw)
        self.encode_fn = encode_fn
        self.target_sr = target_sr
        self.write_cache = write_cache

    def _latents(self, row: dict):
        speech = row["speech"]
        cache = os.path.splitext(speech)[0] + ".melvae.npy"
        if os.path.exists(cache):
            mean_scale = np.load(cache)
        else:
            wav, sr = read_wav(speech)
            wav = resample_linear(wav.mean(axis=0, keepdims=True), sr, self.target_sr)
            mean_scale = np.asarray(self.encode_fn(wav[None].astype(np.float32)))
            if self.write_cache:
                tmp = cache[:-len(".npy")] + ".tmp.npy"
                np.save(tmp, mean_scale)
                os.replace(tmp, cache)
        d = mean_scale.shape[1] // 2
        mean, logs = mean_scale[0, :d], mean_scale[0, d:]
        lat = (mean + np.exp(logs) * self.rng.standard_normal(mean.shape)
               ).astype(np.float32).T
        return lat, mean_scale[0].astype(np.float32).T


class PrefetchLoader:
    """Threaded producer-consumer batch loader: items come from
    `data_pool.finite_iter`, are packed by the token-budget DynamicBatchGenerator,
    collated to static bucket shapes and queued as numpy batches."""

    def __init__(self, dataset: OfflineLatentDataset, pad_token_id: int,
                 max_token_length: int = 11000, batch_size: int = 16,
                 use_dynamic: bool = True, buckets: Optional[Sequence[int]] = None,
                 num_workers: int = 2, prefetch: int = 8):
        self.dataset = dataset
        self.pad_token_id = pad_token_id
        self.buckets = tuple(buckets) if buckets else None
        self.gen_args = (max_token_length, batch_size, use_dynamic)
        self.num_workers = max(1, num_workers)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _produce(self):
        gen = DynamicBatchGenerator(*self.gen_args)
        for it in finite_iter(self.dataset, self.dataset.shuffled_indices(),
                              self.num_workers, self._stop):
            b = gen.add(it)
            if b and not put_until_stopped(
                    self.q, collate(b, self.pad_token_id, self.buckets), self._stop):
                return
        tail = gen.flush()
        if tail and not self._stop.is_set():
            put_until_stopped(self.q, collate(tail, self.pad_token_id, self.buckets),
                              self._stop)
        put_until_stopped(self.q, None, self._stop)  # epoch sentinel

    def epoch_iter(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        self.dataset.set_epoch(epoch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        while True:
            b = self.q.get()
            if b is None:
                break
            yield b

    def close(self) -> None:
        """Stop the producer and its workers and wait for them."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
