"""The spawn harness of the port's multi-process tests and dryrun
(kalle_tpu_torch.parallel.dryrun.spawn) fails the run, never hangs it: a
rank's exception comes back with its traceback, a rank that dies and a
deadline that passes raise, and every other rank (left sleeping) is
killed in time. 2 gloo ranks a spawn."""
import time

import pytest

import torch_parallel_ranks as R
from kalle_tpu_torch.parallel.dryrun import spawn


def test_a_rank_exception_comes_back_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*planted failure"):
        spawn(R.fail, 2, "raise", timeout_s=120)
    assert time.monotonic() - t0 < 60  # rank 0 was killed, not waited for


def test_a_dead_rank_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 died with exit code 3"):
        spawn(R.fail, 2, "exit", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_the_deadline_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 8"):
        spawn(R.fail, 2, "hang", timeout_s=8)
    assert time.monotonic() - t0 < 60
