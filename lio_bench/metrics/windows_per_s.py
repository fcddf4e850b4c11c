"""Windows the program processed in the measured window over the window's
whole wall time (feed, accumulator and spins between steps included)."""


def read(ctx):
    return ctx.windows / ctx.window_s if ctx.windows and ctx.window_s > 0 else None
