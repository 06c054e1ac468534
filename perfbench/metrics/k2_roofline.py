"""K2 `qmm`'s share of its roofline in the traced sub-window: the bound
for the work its launches did over their summed device time. A decode
step launches it once for each of wq, wk, wv and wo in every layer, on all
the batch's rows."""
from perfbench.flops import bound, qmm
from perfbench.tracing import kernel_seconds

LAUNCHES = (r"qmm_kernel",)


def read(ctx):
    got = kernel_seconds(ctx.get("trace"), LAUNCHES)
    if got is None:
        return None
    n, t = got
    m = ctx["batch"]
    per_layer = sum(bound.seconds(qmm.flops(m, k, nn), qmm.nbytes(m, k, nn))
                    for k, nn in qmm.decode_projections(ctx["sizes"]))
    return 100.0 * (n / 4.0) * per_layer / t
