"""The trainer's wait for its input an update: the program's
`train.data_wait` spans (one a batch taken from the loader) summed over
each update, the mean over the window's updates the profiler did not run
in."""
from perfbench import spans


def read(ctx):
    waits = [sum(sp["end_ns"] - sp["start_ns"] for sp in under if sp["name"] == "train.data_wait")
             for _root, under in spans.unprofiled_roots(ctx, "train.update")]
    return sum(waits) / len(waits) / 1e6 if waits else None
