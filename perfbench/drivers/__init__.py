"""Traffic drivers: a traffic file's `driver` names one of these modules.

Each module has `run(run: Run) -> Outcome`: it sets up the cell from the
seed, measures for `run.seconds`, checks what the timed path produced
against the reference, and hands back what the harness prints and what
the metric readers read.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Run:
    cell: str
    cfg: dict                  # the configuration file
    traffic: dict              # the traffic file
    limits: dict               # perfbench/limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]            # name -> value
    checks: Dict[str, dict]                 # name -> {"value", "limit"}
    setup_split: Dict[str, float]           # seconds of each part of set-up
    context: Dict[str, object]              # what the metric readers read
    notes: List[str] = field(default_factory=list)
    memory_peak_bytes: Optional[int] = None

    @property
    def correct(self) -> bool:
        return all(c["value"] is not None and c["value"] <= c["limit"]
                   for c in self.checks.values()) and bool(self.checks)


class Clock:
    """Named set-up parts, timed on the host clock."""

    def __init__(self, start: Optional[float] = None):
        self.parts: Dict[str, float] = {}
        self._t = time.perf_counter() if start is None else start

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._t
        self._t = now
