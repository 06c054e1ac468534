"""The port's native host library (kalle_tpu_torch/native, C++ built with
g++ at first use into build/native/) on the CPU: `align_tokens` against
the JAX package's pure-Python alignment (error counts, as
tests/test_wer_native.py holds the JAX library) and against the port's
`_align_python` op for op (the C++ and Python dynamic programs make the
same choice at every tie); `load_npy` / `load_npy_batch` bit-equal to
np.load for f32, f16, i32 and i64; the library's place (build/native/,
nothing written under kalle_tpu/native/); `eval/wer._align` on the native
path when g++ exists and on the Python path when it does not; a source
that does not compile raises."""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from kalle_tpu.eval.wer import _align_python as jax_align_python
from kalle_tpu_torch.eval import wer
from kalle_tpu_torch.native import host

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE = ROOT / "kalle_tpu" / "native"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the JAX package's own test (tests/test_wer_native.py) may build its
# libkalle_host.so there meanwhile, in another worker, and importing its
# host.py writes __pycache__; everything else stays as it is
_JAX_OWN = {"libkalle_host.so", "__pycache__"}


@pytest.fixture(scope="module", autouse=True)
def jax_native_untouched():
    """kalle_tpu/native/'s listing and mtimes, before and after this file."""
    def listing():
        return {p.name: p.stat().st_mtime_ns for p in JAX_NATIVE.iterdir()
                if p.name not in _JAX_OWN}

    before = listing()
    yield
    assert listing() == before


@pytest.fixture(scope="module")
def lib():
    if not host.have_compiler():
        pytest.skip("no g++ here")
    return host.get_lib()


def _pairs(seed, n=20, vocab=5, max_len=14):
    rng = np.random.default_rng(seed)
    return [([str(x) for x in rng.integers(0, vocab, rng.integers(0, max_len))],
             [str(x) for x in rng.integers(0, vocab, rng.integers(0, max_len))])
            for _ in range(n)]


def _errors(ops):
    return sum(op != "C" for op, _, _ in ops)


def test_library_lands_under_build_native(lib, tmp_path, monkeypatch):
    path = Path(lib._name)
    assert path.parent == ROOT / "build" / "native"
    assert path == host.library_path() and path.exists()
    # what a build runs and writes: g++ on the port's source, into build_dir
    cmds = []
    real = host.subprocess.run
    monkeypatch.setattr(host.subprocess, "run",
                        lambda cmd, **kw: cmds.append(cmd) or real(cmd, **kw))
    out = host.build(host.SRC, tmp_path)
    assert len(cmds) == 1 and str(host.SRC) in cmds[0]
    assert out.parent == tmp_path and not any(str(JAX_NATIVE) in a for a in cmds[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_counts_match_the_jax_alignment(lib, seed):
    for ref, hyp in _pairs(seed):
        assert _errors(host.align_tokens(ref, hyp)) == _errors(jax_align_python(ref, hyp))


@pytest.mark.parametrize("seed,vocab", [(3, 3), (4, 5), (5, 30)])
def test_align_matches_python_op_for_op(lib, seed, vocab):
    for ref, hyp in _pairs(seed, vocab=vocab):
        assert host.align_tokens(ref, hyp) == wer._align_python(ref, hyp)


def test_align_unique_optimum(lib):
    # distinct tokens, the edits far apart: one substitution, one deletion,
    # one insertion, and no other alignment with three errors
    ref, hyp = list("abcdefghij"), list("aXcdfghiZj")
    ops = host.align_tokens(ref, hyp)
    assert ops == wer._align_python(ref, hyp) == jax_align_python(ref, hyp)
    assert [op for op, _, _ in ops] == ["C", "S", "C", "C", "D", "C", "C", "C", "C", "I", "C"]
    assert host.align_tokens([], []) == [] and host.align_tokens(["a"], []) == [("D", 0, -1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int64])
def test_load_npy_bit_equal(lib, tmp_path, dtype):
    rng = np.random.default_rng(1)
    arrays = [(rng.normal(size=shape) * 100).astype(dtype)
              for shape in ((3, 4, 5), (7,), (1, 33, 8), ())]
    paths = []
    for i, a in enumerate(arrays):
        p = str(tmp_path / f"x{i}.npy")
        np.save(p, a)
        paths.append(p)
    for p, a in zip(paths, arrays):
        got = host.load_npy(p)
        assert got.dtype == a.dtype and got.shape == a.shape
        assert got.tobytes() == np.load(p).tobytes()
    for got, p in zip(host.load_npy_batch(paths, n_threads=2), paths):
        ref = np.load(p)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def test_load_npy_rejects_fortran_and_missing(lib, tmp_path):
    p = str(tmp_path / "f.npy")
    np.save(p, np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4)))
    with pytest.raises(IOError):
        host.load_npy(p)
    with pytest.raises(IOError):
        host.load_npy_batch([str(tmp_path / "missing.npy")])


def test_wer_align_takes_the_native_path(lib, monkeypatch):
    calls = []
    real = host.align_tokens

    def spy(ref, hyp):
        calls.append((ref, hyp))
        return real(ref, hyp)

    monkeypatch.setattr(host, "align_tokens", spy)
    r = wer.score_pair("u", "the cat sat", "the bat sat down", char_level=False)
    assert calls and (r.sub, r.ins, r.dele) == (1, 1, 0)


def test_wer_align_without_gpp_takes_python(monkeypatch):
    def boom(ref, hyp):
        raise AssertionError("the native path ran without g++")

    monkeypatch.setattr(host.shutil, "which", lambda name: None)
    monkeypatch.setattr(host, "_compiler", None)  # look g++ up again: missing
    monkeypatch.setattr(host, "align_tokens", boom)
    assert not host.have_compiler()
    for ref, hyp in _pairs(6):
        assert wer._align(ref, hyp) == wer._align_python(ref, hyp)


def test_a_source_that_does_not_compile_raises(tmp_path):
    if not host.have_compiler():
        pytest.skip("no g++ here")
    src = tmp_path / "host.cpp"
    src.write_text(host.SRC.read_text().replace('extern "C" {', 'extern "C" { not C++'))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.build(src, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))


def test_build_reuses_an_unchanged_source(lib, tmp_path):
    a = host.build(host.SRC, tmp_path)
    mtime = os.stat(a).st_mtime_ns
    assert host.build(host.SRC, tmp_path) == a and os.stat(a).st_mtime_ns == mtime
    edited = tmp_path / "edited.cpp"
    edited.write_text(host.SRC.read_text() + "\n// edited\n")
    assert host.library_path(edited, tmp_path) != a
