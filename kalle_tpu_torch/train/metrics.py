"""Scalar metrics: JSONL always, TensorBoard when its import succeeds (copy
of kalle_tpu/train/metrics.py), plus the plain-text train log."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self.text_path = os.path.join(log_dir, "train_log.txt")
        self._f = open(self.jsonl_path, "a", encoding="utf-8")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._tb = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def text_log(self, line: str) -> None:
        with open(self.text_path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
