"""Host ms per window inside the program's `sync.*` waits (each place where
the host waits for the card: probe rounds, the "auto" refresh, eigensolves,
`nonzero`, copies of host memory, the telemetry read), over the untraced
windows that follow the trace in a `--trace 1` run, as `runtime.host_ms`
reads them; from the program's window log (program_log.py)."""

from lio_bench.program_log import growth


def read(ctx):
    g = growth(ctx.host_windows)
    if g is None:
        return None
    return sum(g.wait_ns.values()) / 1e6 / ctx.host_windows
