"""Share of the traced window in which no kernel, copy or fill ran on the
device."""


def read(ctx):
    if ctx.events is None or ctx.traced_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
