"""The share of the traced sub-window in which the card is idle while the
trainer's thread waits for a batch (`train.data_wait`) or stacks and copies
it to the card (`train.stack`), on the device trace's clock
(`perfbench/spans.py`)."""
from perfbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, ["train.data_wait", "train.stack"], thread_of="train.step")
