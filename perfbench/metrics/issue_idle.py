"""The share of the traced sub-window in which the card is idle while the
program's thread is in a `gen.step` outside its `gen.flag_read` (and
outside the profiler's clock anchors, `trace.anchor`): idle time the host's
issue of a step leaves, on the device trace's clock (`perfbench/spans.py`)."""
from perfbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, ["gen.step"], minus=["gen.flag_read", spans.ANCHOR_SPAN])
