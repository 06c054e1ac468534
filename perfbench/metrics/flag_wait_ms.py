"""The host's time blocked on the card a decode step: the mean of the
program's `gen.flag_read` spans (the stop flags' read, which waits for the
step before), over the steps of the window's calls the profiler did not
run in."""
from perfbench import spans


def read(ctx):
    steps = spans.decode_steps(ctx)
    return sum(f for _s, f in steps) / len(steps) / 1e6 if steps else None
