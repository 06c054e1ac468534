"""The whole step's share of the card's bf16 peak: the model operations of
the window's work (`flops`, counted by the driver from shapes with
perfbench/flops: training 6 N a token plus the causal attention, serving
the prompts prefilled, the frames decoded at their context and the codec's
decodes) over the window's length times 989 TFLOP/s."""
from perfbench.common import H100_BF16_FLOP_PER_S


def read(ctx):
    if not ctx.get("flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * H100_BF16_FLOP_PER_S)
