"""Host ms per processed window in the program's `spin_idle` stage
(runtime/pipeline.py: the `spin_once` calls that processed no window: with
real-time windows and a spin after every IMU sample, the samples that do
not yet fill a window), over the untraced windows that follow the trace in
a `--trace 1` run, as `step.dispatch_ms` reads them; from the program's
window log (program_log.py).  A program without the stage gives None."""

from lio_bench.program_log import growth


def read(ctx):
    g = growth(ctx.host_windows)
    if g is None or "spin_idle" not in g.stage_ns:
        return None
    return g.stage_ns["spin_idle"] / 1e6 / ctx.host_windows
