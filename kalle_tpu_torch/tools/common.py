"""What the port's tools share: the device a tool runs on, a device
fence, and percentiles as the JAX tools compute them."""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def device(name: str) -> torch.device:
    """torch.device(name); a CUDA device on a host without a card raises
    (a bench never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here (pass --device cpu)")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pct(values: Iterable[float], q: float, ndigits: int = 3) -> Optional[float]:
    """The JAX tools' percentile: the sorted value at int(n * q), capped at
    the last; None for no values."""
    v = sorted(values)
    if not v:
        return None
    return round(v[min(int(len(v) * q), len(v) - 1)], ndigits)


# published peaks of one NVIDIA H100 SXM (dense, 700 W): the yardsticks of
# the bound and MFU columns, meaningful for a run on that card
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOP_PER_S = 989e12


def device_ms(step, k: int, dev: torch.device, iters: int = 3):
    """Milliseconds a call of `step` (a function of no arguments whose calls
    chain through state it keeps). On the card `k` calls are captured into
    one CUDA graph and `iters` replays are timed with CUDA events, so the
    host's launch cost is out ("cuda_graph"); on the CPU, the host clock
    over eager calls ("host"). -> (ms, how, the times `step`'s work ran:
    the warm-up call, then each of k calls a replay, or each eager call).
    A capture records its launches and runs none, so the launch counts get
    the recorded launches once for each replay."""
    import time

    from ..ops.kernels import _build

    step()  # warm-up: builds the kernels, settles the allocator
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters * k):
            step()
        return (time.perf_counter() - t0) * 1e3 / (iters * k), "host", 1 + iters * k
    before = _build.launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            step()
    replays = 1 + iters
    for name, n in _build.launches().items():
        if n > before.get(name, 0):
            _build.count(name, (n - before.get(name, 0)) * (replays - 1))
    graph.replay()
    sync(dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (iters * k), "cuda_graph", 1 + replays * k
