"""device_idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the card (the union of their intervals from the
profiler's device trace). Layer: device (one H100); it moves fps."""

LAYER = "device"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
