"""The threaded item producer (copy of the epoch mode of
kalle_tpu/data/data_pool.py, `DataPrefetchPool.finite_iter`, as a function).

`finite_iter` yields dataset[i] for each index exactly once, produced by
`num_workers` threads over the partition idxs[w::num_workers], in
completion order: with more than one worker the order of items, and so the
make-up of each batch, changes from run to run. One worker is
deterministic. Workers poll `stop` while the queue is full, so a consumer
that stops early leaves no thread blocked.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence


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
