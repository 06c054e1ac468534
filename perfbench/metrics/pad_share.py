"""The share of the positions the forward computes that are padding, over
the window's updates the profiler did not run in: 100 (1 - real / slots)
from the program's counts of each update, its `train.step` span's attrs
`tokens_real` (caption ids and frames of the collated masks) and
`tokens_slots` (the stacked batch's A x B x T), which also grow the
counters `train.tokens_real` and `train.tokens_slots`."""
from perfbench import spans


def read(ctx):
    real, slots = spans.update_tokens(ctx)
    return 100.0 * (1.0 - real / slots) if slots else None
