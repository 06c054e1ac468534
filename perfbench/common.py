"""What every part of the benchmark shares: the card's published peaks,
percentiles, seeded sub-seeds, quantile sets and texts, the import guard,
and the result line."""
from __future__ import annotations

import json
import math
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W)
H100_BF16_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# top-level module names a run may not load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kalle_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one named stream of a run's seed (a run's seed may
    exceed 32 bits)."""
    x = int(seed) % (2 ** 63)
    for p in parts:
        x = (x * 1_000_003 + int(p) + 1) % (2 ** 63)
    return x


def quantile_set(n: int, ppf) -> List[float]:
    """n values at the mid-quantiles (i + 0.5) / n of a distribution given
    by its inverse CDF: every seed gets the same set, in its own order."""
    return [ppf((i + 0.5) / n) for i in range(n)]


def exponential_ppf(rate: float):
    return lambda u: -math.log(1.0 - u) / rate


def lognormal_int_ppf(lo: int, hi: int):
    """A lognormal whose 1st and 99th percentiles are lo and hi, rounded
    and clipped to [lo, hi]."""
    mu = 0.5 * (math.log(lo) + math.log(hi))
    nd = statistics.NormalDist(mu, (math.log(hi) - math.log(lo)) / (2 * 2.3263))
    return lambda u: int(min(hi, max(lo, round(math.exp(nd.inv_cdf(u))))))


def text_of(rng, n: int) -> str:
    """n characters of lowercase words drawn from `rng` (a random.Random),
    single spaces between them, none at either end."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    words, size = [], -1
    while size < n:
        w = "".join(rng.choice(letters) for _ in range(rng.randint(2, 9)))
        words.append(w)
        size += len(w) + 1
    text = " ".join(words)[:n]
    return text[:-1] + rng.choice(letters) if text.endswith(" ") else text


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, breakdown: Optional[dict] = None,
                checks: Optional[Dict[str, dict]] = None) -> str:
    """The last line of standard output. `checks` (each compared number
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if checks is not None:
        out["checks"] = checks
    return json.dumps(out)
