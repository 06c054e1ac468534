"""Sequence packing and collation, numpy, host side (copy of
kalle_tpu/data/collate.py, the CFG mask dropout included).

Mask semantics of the reference collate:
  * one packed row per sample: [text ids][audio frames];
  * labels initialised to ONES, so pad frames match the end distribution;
  * labels shifted by -1: distribute_labels[s-1:e-1] = audio_distribution;
  * the end mask at e-1.
`bucket_length` rounds the packed length up to a static bucket.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Item:
    """One dataset item before packing."""

    input_ids: np.ndarray  # (s,) int
    audio_latents: np.ndarray  # (T, d)
    audio_distribution: np.ndarray  # (T, d or 2d)
    raw_text: str = ""
    speech_path: str = ""

    @property
    def item_len(self) -> int:
        return int(self.input_ids.shape[0] + self.audio_latents.shape[0])


def bucket_length(n: int, buckets: Optional[Sequence[int]]) -> int:
    """Round n up to the nearest bucket (the last bucket caps)."""
    if not buckets:
        return n
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]


def collate(batch: List[Item], pad_token_id: int,
            buckets: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    b = len(batch)
    audio_dim = batch[0].audio_latents.shape[-1]
    dist_dim = batch[0].audio_distribution.shape[-1]
    max_len = bucket_length(max(it.item_len for it in batch), buckets)

    input_ids = np.full((b, max_len), pad_token_id, np.int32)
    audio_latents = np.zeros((b, max_len, audio_dim), np.float32)
    labels = np.ones((b, max_len, dist_dim), np.float32)  # ones-init
    ids_mask = np.zeros((b, max_len), bool)
    audio_mask = np.zeros((b, max_len), bool)
    target_mask = np.zeros((b, max_len), bool)
    end_mask = np.zeros((b, max_len), bool)

    raw_texts, speech_paths = [], []
    for i, it in enumerate(batch):
        s = it.input_ids.shape[0]
        e = s + it.audio_latents.shape[0]
        input_ids[i, :s] = it.input_ids
        audio_latents[i, s:e] = it.audio_latents
        labels[i, s - 1:e - 1] = it.audio_distribution
        ids_mask[i, :s] = True
        audio_mask[i, s:e] = True
        target_mask[i, s - 1:e - 1] = True
        end_mask[i, e - 1] = True
        raw_texts.append(it.raw_text)
        speech_paths.append(it.speech_path)

    return {
        "input_ids": input_ids,
        "audio_latents": audio_latents,
        "distribute_labels": labels,
        "ids_mask": ids_mask,
        "audio_mask": audio_mask,
        "target_mask": target_mask,
        "end_mask": end_mask,
        "raw_texts": raw_texts,
        "speech_paths": speech_paths,
    }


def cfg_mask_dropout(batch: Dict[str, np.ndarray], cfg_prob: float,
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """CFG training: drop each audio position from the attention mask with
    probability cfg_prob (the reference's attention_mask = ids_mask +
    audio_latents_mask). The latents stay in the input embeddings."""
    out = dict(batch)
    drop = rng.random(batch["audio_mask"].shape) < cfg_prob
    out["audio_mask"] = np.logical_and(batch["audio_mask"], ~drop)
    return out


def pad_batch_rows(batch: Dict[str, np.ndarray], multiple: int,
                   pad_token_id: int) -> Dict[str, np.ndarray]:
    """Pad the batch dim to a multiple of `multiple` with loss-neutral rows
    (all masks zero)."""
    b = batch["input_ids"].shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        pad = np.zeros((rem,) + v.shape[1:], v.dtype)
        if k == "input_ids":
            pad[:] = pad_token_id
        elif k == "distribute_labels":
            pad[:] = 1  # keep the ones-init convention
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def stack_microbatches(batches: List[Dict[str, np.ndarray]],
                       pad_token_id: int) -> Dict[str, np.ndarray]:
    """Stack A collated batches into (A, B, ...) arrays for gradient
    accumulation, padding each to the group's largest shape with
    loss-neutral values (pad token, ones-init labels, zero masks)."""
    keys = [k for k, v in batches[0].items() if isinstance(v, np.ndarray)]
    out = {}
    for k in keys:
        arrs = [b[k] for b in batches]
        tgt = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
        fill = pad_token_id if k == "input_ids" else 1 if k == "distribute_labels" else 0
        padded = []
        for a in arrs:
            if a.shape != tgt:
                p = np.full(tgt, fill, a.dtype)
                p[tuple(slice(0, s) for s in a.shape)] = a
                a = p
            padded.append(a)
        out[k] = np.stack(padded, axis=0)
    return out


class DynamicBatchGenerator:
    """Token-budget batching: the batch closes when
    max_item_len * (n+1) > max_token_length or n >= batch_size."""

    def __init__(self, max_token_length: int, batch_size: int = 9999999,
                 use_dynamic: bool = True):
        self.max_token_length = max_token_length
        self.batch_size = batch_size
        self.use_dynamic = use_dynamic
        self.cur_batch: List[Item] = []
        self.cur_batch_max_len = 0

    def add(self, item: Optional[Item]) -> Optional[List[Item]]:
        if item is None:
            return None
        if not self.use_dynamic:
            self.cur_batch.append(item)
            if len(self.cur_batch) >= self.batch_size:
                out, self.cur_batch = self.cur_batch, []
                return out
            return None

        item_len = item.item_len
        tmp_len = max(item_len, self.cur_batch_max_len)
        if (tmp_len * (len(self.cur_batch) + 1) <= self.max_token_length
                and len(self.cur_batch) < self.batch_size):
            self.cur_batch.append(item)
            self.cur_batch_max_len = tmp_len
            return None
        out = self.cur_batch
        if item_len < self.max_token_length:
            self.cur_batch = [item]
            self.cur_batch_max_len = item_len
        else:  # an oversized item is dropped
            self.cur_batch = []
            self.cur_batch_max_len = 0
        return out

    def flush(self) -> Optional[List[Item]]:
        if self.cur_batch:
            out, self.cur_batch = self.cur_batch, []
            self.cur_batch_max_len = 0
            return out
        return None
