"""setup_s: seconds from the process's start to the first measured frame:
imports, the CUDA context, weights, the native builds' loads and the
warm-up of every chunk shape the cell's traffic uses (host clock)."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
