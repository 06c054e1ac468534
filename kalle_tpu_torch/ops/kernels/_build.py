"""Build, load and count the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` is compiled at first use, on its own, into a shared
library with a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. `build()` starts one nvcc per
source, all at once. nvcc's resource report (-Xptxas -v) is kept beside
each library as `<lib>.log`.

Every C entry point returns `cudaGetLastError()`; `check()` raises on any
code but 0. `count()` adds one launch of a wrapper's kernel: a wrapper
calls it where it launches its kernel (one launch a call) and nowhere
else; `launches()` reads the counts and `reset_launches()` clears them.
Loading and counting share one lock, so the wrappers may be called from
several threads (the serving decode thread and the HTTP handlers' codec
decodes).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "qmm", "convnext_block", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int

_launches: collections.Counter = collections.Counter()
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        _launches.clear()


def count(name: str, n: int = 1) -> None:
    """n launches of the wrapper `name`'s kernel (a CUDA graph's replays
    run what one capture recorded)."""
    with _lock:
        _launches[name] += n


def launches() -> Dict[str, int]:
    """A copy of the counts."""
    with _lock:
        return dict(_launches)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def _library(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together. Returns the seconds each build took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, tmp, time.perf_counter())
    seconds, errors = {}, []
    for name, (proc, lib, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log[-4000:]}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed, with argtypes set
    for each entry point in `signatures` (restype int: a CUDA error)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library(name)))
            lib.kt_error_string.argtypes = [I]
            lib.kt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = I
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.kt_error_string(rc).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t):
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def describe(*tensors: torch.Tensor) -> str:
    """dtype, shape and layout of each tensor, for a wrapper's error."""
    return "; ".join(f"{t.dtype} {tuple(t.shape)}"
                     + ("" if t.is_contiguous() else " non-contiguous")
                     + ("" if t.data_ptr() % 32 == 0 else " unaligned")
                     for t in tensors)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when every one is on a CUDA device (the kernel runs); a mix, or
    another device, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: the kernels take "
                     "CUDA tensors, their plain versions CPU tensors")


def aligned(*tensors: torch.Tensor) -> bool:
    """Contiguous, with the data starting on a 32-byte boundary (the
    kernels' vector and tensor-core loads need it)."""
    return all(t.is_contiguous() and t.data_ptr() % 32 == 0 for t in tensors)
