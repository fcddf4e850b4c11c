"""Host ms per window inside the program's `step` stage (runtime/pipeline.py:
the host enqueueing the eager `lio_step` on the card) less its `sync.*`
waits inside it (the host waiting for the card), over the untraced windows
that follow the trace in a `--trace 1` run, as `runtime.host_ms` reads
them; from the program's window log (program_log.py)."""

from lio_bench.program_log import growth


def read(ctx):
    g = growth(ctx.host_windows)
    if g is None or not g.stage_ns.get("step"):
        return None
    return (g.stage_ns["step"] - g.wait_ns.get("step", 0)) / 1e6 / ctx.host_windows
