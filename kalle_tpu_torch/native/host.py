"""ctypes bindings for the port's native host library (copy of
kalle_tpu/native/host.py over `native/host.cpp`).

The library is compiled with g++ at first use into the repository's
`build/native/` (ignored by git):

    g++ -O3 -std=c++17 -shared -fPIC -pthread native/host.cpp
        -o build/native/libkalle_host-<hash>.so

The name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one reused; the library is written under a
temporary name and renamed into place, so processes that build at once do
not see a partial file. A failed build or load raises. Callers that have a
pure-Python path (eval/wer._align) take it only when g++ is missing
(`have_compiler`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_compiler: Optional[bool] = None


def have_compiler() -> bool:
    """Whether g++ is on PATH (looked up once: a PATH walk costs as much as
    aligning a 70-token pair)."""
    global _compiler
    if _compiler is None:
        _compiler = shutil.which("g++") is not None
    return _compiler


def library_path(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(Path(src).read_bytes())
    return Path(build_dir) / f"libkalle_host-{h.hexdigest()[:12]}.so"


def build(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `src` unless its library exists; returns the library's path.
    Raises RuntimeError with g++'s output when the compile fails."""
    lib = library_path(src, build_dir)
    if lib.exists():
        return lib
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the native host library is built at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([compiler, *FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The library of `native/host.cpp`, built if needed, loaded once, with
    every entry point's argtypes and restype set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.kalle_align.restype = ctypes.c_int64
        lib.kalle_align.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.kalle_npy_info.restype = ctypes.c_int32
        lib.kalle_npy_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.kalle_npy_read.restype = ctypes.c_int32
        lib.kalle_npy_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.kalle_npy_read_batch.restype = ctypes.c_int32
        lib.kalle_npy_read_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return lib


_OPS = {0: "C", 1: "S", 2: "D", 3: "I"}
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.int64}


def align_tokens(ref: Sequence[str], hyp: Sequence[str]):
    """Edit-distance alignment; same op-list contract as eval.wer._align."""
    lib = get_lib()
    vocab: Dict[str, int] = {}

    def ids(tokens):
        out = np.empty(len(tokens), np.int32)
        for i, t in enumerate(tokens):
            out[i] = vocab.setdefault(t, len(vocab))
        return out

    r, h = ids(ref), ids(hyp)
    cap = 3 * (len(ref) + len(hyp) + 1)
    ops = np.empty(cap, np.int32)
    n = lib.kalle_align(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(r),
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(h),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if n < 0:
        raise RuntimeError("kalle_align overflow")
    out = [(_OPS[int(ops[3 * k])], int(ops[3 * k + 1]), int(ops[3 * k + 2]))
           for k in range(int(n))]
    out.reverse()  # the C side emits backtrace order
    return out


def npy_info(path: str) -> Tuple[Tuple[int, ...], np.dtype]:
    lib = get_lib()
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int32()
    dtype = ctypes.c_int32()
    rc = lib.kalle_npy_info(path.encode(), shape, ctypes.byref(ndim), ctypes.byref(dtype))
    if rc != 0:
        raise IOError(f"npy_info({path}) rc={rc}")
    return tuple(shape[i] for i in range(ndim.value)), np.dtype(_DTYPES[dtype.value])


def load_npy(path: str) -> np.ndarray:
    """Native np.load for C-order little-endian f4/f2/i4/i8 arrays."""
    lib = get_lib()
    shape, dt = npy_info(path)
    out = np.empty(shape, dt)
    rc = lib.kalle_npy_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise IOError(f"npy_read({path}) rc={rc}")
    return out


def load_npy_batch(paths: Sequence[str], n_threads: int = 4) -> List[np.ndarray]:
    """Concurrent batched .npy load on `n_threads` native threads."""
    lib = get_lib()
    arrays = []
    bufs = (ctypes.c_void_p * len(paths))()
    sizes = (ctypes.c_int64 * len(paths))()
    for i, p in enumerate(paths):
        shape, dt = npy_info(p)
        a = np.empty(shape, dt)
        arrays.append(a)
        bufs[i] = a.ctypes.data_as(ctypes.c_void_p).value
        sizes[i] = a.nbytes
    packed = b"\0".join(p.encode() for p in paths) + b"\0"
    status = (ctypes.c_int32 * len(paths))()
    lib.kalle_npy_read_batch(packed, len(paths), bufs, sizes, n_threads, status)
    for i, p in enumerate(paths):
        if status[i] != 0:
            raise IOError(f"npy_read({p}) rc={status[i]}")
    return arrays
