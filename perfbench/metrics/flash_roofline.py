"""K5-K7's share of their roofline in the traced sub-window: the summed
bound of the flash forward and backward work of the traced steps (causal
pairs of valid positions; q, k, v, o, dO read and dq, dk, dv written once)
over the summed device time of their launches."""
from perfbench.tracing import kernel_seconds

LAUNCHES = (r"flash_fwd", r"flash_dq", r"flash_dkv")


def read(ctx):
    got = kernel_seconds(ctx.get("trace"), LAUNCHES)
    if got is None or not ctx.get("flash_bound_s"):
        return None
    return 100.0 * ctx["flash_bound_s"] / got[1]
