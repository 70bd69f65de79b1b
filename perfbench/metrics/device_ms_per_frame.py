"""device_ms_per_frame: device busy time (the union of kernel, memcpy and
memset intervals in the traced window) per frame the window returned.
Layer: device (one H100); it moves fps."""

LAYER = "device"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    if ctx.trace.busy_s <= 0 or not ctx.frames:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.frames
