"""fps: whole frames the program returned (inpainted or passed through) over
the whole measured window, from its first frame handed out to the return
of the last frame it took (host clock)."""

UNIT = "frames/s"


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.frames else None
