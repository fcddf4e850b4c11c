"""Seconds from the start of the process to the first measured window:
imports, CUDA start, kernel builds, rendering, set-up map laps and the
warm-up ramp."""


def read(ctx):
    return ctx.setup_s
