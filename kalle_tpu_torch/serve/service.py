"""One continuous batcher shared by concurrent requests (port of
kalle_tpu/serve/service.py:32-161).

A background decode thread owns one `ContinuousBatcher`; request handlers
on any thread submit prompts and read their rows' Chunk events from
per-request queues, so N concurrent clients share one decode batch with
admission mid-decode.

Queue events: ("chunk", Chunk), ("done", Completion) or ("error", exc); a
trailing None closes the stream. An error on the decode thread reaches
every waiting request as ("error", exc).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Tuple

import numpy as np

from ..core.config import LlasaConfig
from ..infer.serve_loop import Chunk, ContinuousBatcher


class BatcherService:
    """Background decode thread around one ContinuousBatcher.

    submit() is thread-safe; each request gets its own event queue. The
    decode loop admits pending prompts into free rows, steps the batch
    `chunk_frames` frames at a time, and routes windowed Chunk fetches
    (ContinuousBatcher.poll_chunks) to their requests. Runs on `device`
    ("cuda" unless the caller asks for the CPU).
    """

    def __init__(self, params: dict, cfg: LlasaConfig, batch_size: int = 8,
                 max_frames: int = 200, chunk_frames: int = 25,
                 prompt_buckets=(16, 32, 64, 128), seed: int = 0,
                 greedy: bool = False, device="cuda"):
        self.cb = ContinuousBatcher(params, cfg, batch_size=batch_size,
                                    max_frames=max_frames, prompt_buckets=prompt_buckets,
                                    seed=seed, greedy=greedy, device=device)
        self.chunk_frames = max(int(chunk_frames), 1)
        self._submit_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._outs: Dict[int, queue.SimpleQueue] = {}
        self._outs_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kalle-decode-loop")
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, ids: np.ndarray) -> Tuple[int, "queue.SimpleQueue"]:
        """Enqueue a prompt; returns (request id, event queue)."""
        if self._stop.is_set():
            raise RuntimeError("BatcherService is closed")
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        q: "queue.SimpleQueue" = queue.SimpleQueue()
        with self._outs_lock:
            self._outs[rid] = q
        self._submit_q.put((rid, np.asarray(ids, np.int64)))
        return rid, q

    def close(self, join: bool = True) -> None:
        self._stop.set()
        self._submit_q.put(None)  # wake an idle loop
        if join:
            self._thread.join(timeout=30)
        # release any handler still blocked on its event queue
        with self._outs_lock:
            outs, self._outs = list(self._outs.values()), {}
        for q in outs:
            q.put(None)

    # -- decode loop -------------------------------------------------------

    def _route(self, rid: int, event) -> None:
        with self._outs_lock:
            q = self._outs.get(rid)
        if q is not None:
            q.put(event)

    def _finish(self, rid: int) -> None:
        with self._outs_lock:
            q = self._outs.pop(rid, None)
        if q is not None:
            q.put(None)

    def _loop(self) -> None:
        cb = self.cb
        pending: List[Tuple[int, np.ndarray]] = []
        emitted: Dict[int, int] = {}
        try:
            while not self._stop.is_set():
                try:  # drain queued submissions without blocking
                    while True:
                        item = self._submit_q.get_nowait()
                        if item is not None:
                            pending.append(item)
                except queue.Empty:
                    pass
                free = cb._free_rows()
                if not pending and len(free) == cb.B:
                    # idle: wait for the next submission (a short timeout,
                    # so close() is honoured promptly)
                    try:
                        item = self._submit_q.get(timeout=0.2)
                        if item is not None:
                            pending.append(item)
                    except queue.Empty:
                        pass
                    continue
                while pending and free:
                    rid, ids = pending.pop(0)
                    cb._admit(free.pop(0), rid, ids)
                    emitted[rid] = 0
                cb._step(self.chunk_frames)
                for ch in cb.poll_chunks(emitted, window=self.chunk_frames):
                    self._route(ch.index, ("chunk", ch))
                for c in cb._harvest():
                    if emitted.get(c.index, 0) < c.n_frames:
                        lo = emitted[c.index]
                        self._route(c.index, ("chunk", Chunk(
                            index=c.index, means=c.means[lo:], samples=c.samples[lo:],
                            start_frame=lo, final=True)))
                    emitted.pop(c.index, None)
                    self._route(c.index, ("done", c))
                    self._finish(c.index)
        except BaseException as e:  # noqa: BLE001 — tell every waiter, then re-raise
            with self._outs_lock:
                outs, self._outs = list(self._outs.values()), {}
            for q in outs:
                q.put(("error", e))
                q.put(None)
            if not self._stop.is_set():
                raise
