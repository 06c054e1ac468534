"""The host's time to issue one decode step: the mean self time of the
program's `gen.step` spans outside their `gen.flag_read`, over the steps of
the window's calls the profiler did not run in."""
from perfbench import spans


def read(ctx):
    steps = spans.decode_steps(ctx)
    return sum(s - f for s, f in steps) / len(steps) / 1e6 if steps else None
