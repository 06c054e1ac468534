"""The threaded item producers (copy of kalle_tpu/data/data_pool.py).

Two modes:
  * the reference's infinite sampled stream: `DataPrefetchPool` (worker
    threads filling a bounded queue with random or wrap-around indices,
    backing off while it is 90% full; `start`/`get`/`stop`), read by
    `PrefetchDataIterator` (fixed batch size) or
    `DynamicPrefetchBatchIterator` (token-budget batches);
  * the epoch mode, `finite_iter` (`DataPrefetchPool.finite_iter` as a
    function), which `datasets.PrefetchLoader` builds on.

With one worker the stream is deterministic: the indices come from
`random.Random(seed)` in order. An item whose read raises is skipped.

`finite_iter` yields dataset[i] for each index exactly once, produced by
`num_workers` threads over the partition idxs[w::num_workers], in
completion order: with more than one worker the order of items, and so the
make-up of each batch, changes from run to run. One worker is
deterministic. Workers poll `stop` while the queue is full, so a consumer
that stops early leaves no thread blocked.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

from .collate import DynamicBatchGenerator


def put_until_stopped(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """q.put(item), giving up (False) once `stop` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def finite_iter(dataset, idxs: Sequence[int], num_workers: int,
                stop: threading.Event) -> Iterator:
    """Yield dataset[i] for each i in idxs exactly once, produced by
    `num_workers` threads over idxs[w::num_workers], in completion order."""
    item_q: "queue.Queue" = queue.Queue(maxsize=num_workers * 4)

    def worker(sub):
        for i in sub:
            if stop.is_set() or not put_until_stopped(item_q, dataset[i], stop):
                return
        put_until_stopped(item_q, None, stop)

    threads = [threading.Thread(target=worker, args=(idxs[w::num_workers],), daemon=True)
               for w in range(num_workers)]
    for t in threads:
        t.start()
    finished = 0
    while finished < num_workers and not stop.is_set():
        it = item_q.get()
        if it is None:
            finished += 1
            continue
        yield it


class DataPrefetchPool:
    """The infinite sampled stream: `num_workers` threads put
    dataset[index] into a queue of `max_size` items, the index drawn at
    random (shuffle) or walking the rows with wrap-around."""

    def __init__(self, dataset, prefetch_size: int = 1000, max_size: int = 1000,
                 num_workers: int = 2, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=max_size)
        self.prefetch_size = prefetch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self._stop = threading.Event()
        self._rng = random.Random(seed)
        self._threads: List[threading.Thread] = []
        self._cursor = 0
        self._lock = threading.Lock()

    def _next_index(self) -> int:
        with self._lock:
            if self.shuffle:
                return self._rng.randrange(len(self.dataset))
            i = self._cursor
            self._cursor = (self._cursor + 1) % len(self.dataset)
            return i

    def _worker(self) -> None:
        while not self._stop.is_set():
            if self.q.qsize() >= 0.9 * self.q.maxsize:  # back off while nearly full
                time.sleep(0.05)
                continue
            idx = self._next_index()
            try:
                item = self.dataset[idx]
            except Exception:  # noqa: BLE001 — the reference skips a failed read
                continue
            try:
                self.q.put(item, timeout=1.0)
            except queue.Full:
                pass

    def start(self) -> "DataPrefetchPool":
        self._stop.clear()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()
        return self

    def get(self, timeout: Optional[float] = 10.0):
        return self.q.get(timeout=timeout)

    def qsize(self) -> int:
        return self.q.qsize()

    def stop(self) -> None:
        """Stop the workers, drop what is queued and wait for them."""
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                self._drain()
                t.join(timeout=0.1)
        self._threads = []
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


class PrefetchDataIterator:
    """Fixed-size batches from a started DataPrefetchPool, collated by
    `collate_fn` when one is given."""

    def __init__(self, pool: DataPrefetchPool, batch_size: int,
                 collate_fn: Optional[Callable] = None):
        self.pool = pool
        self.batch_size = batch_size
        self.collate_fn = collate_fn

    def __iter__(self):
        return self

    def __next__(self):
        batch = [self.pool.get() for _ in range(self.batch_size)]
        return self.collate_fn(batch) if self.collate_fn else batch


class DynamicPrefetchBatchIterator:
    """Token-budget batches (DynamicBatchGenerator) from a started
    DataPrefetchPool."""

    def __init__(self, pool: DataPrefetchPool, max_token_length: int,
                 batch_size: int = 9999999, collate_fn: Optional[Callable] = None):
        self.pool = pool
        self.gen = DynamicBatchGenerator(max_token_length, batch_size)
        self.collate_fn = collate_fn

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            batch = self.gen.add(self.pool.get())
            if batch:
                return self.collate_fn(batch) if self.collate_fn else batch
