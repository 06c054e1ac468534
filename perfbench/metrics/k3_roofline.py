"""K3 `fused_mlp`'s share of its roofline in the traced sub-window: the
bound for the work its launches did (one a layer and decode step, on all
the batch's rows) over the summed device time of its MLP kernel and the
kernel that sums its clusters."""
from perfbench.flops import bound, fused_mlp
from perfbench.tracing import kernel_seconds

LAUNCHES = (r"mlp_kernel",)
ALSO = (r"k3::sum_kernel", r"2k310sum_kernel")


def read(ctx):
    got = kernel_seconds(ctx.get("trace"), LAUNCHES)
    if got is None:
        return None
    n, t = got
    extra = kernel_seconds(ctx["trace"], ALSO)
    t += extra[1] if extra else 0.0
    s, m = ctx["sizes"], ctx["batch"]
    b = bound.seconds(fused_mlp.flops(m, s["hidden"], s["ffn"]),
                      fused_mlp.nbytes(m, s["hidden"], s["ffn"]))
    return 100.0 * n * b / t
