"""The language model's time a decode step: the host-clock seconds in
which the window's decode loop ran (`lm_s`) over the decode steps the
program counted in them (`decode_steps`)."""


def read(ctx):
    steps = ctx.get("decode_steps")
    return ctx["lm_s"] * 1e3 / steps if steps and ctx.get("lm_s") else None
