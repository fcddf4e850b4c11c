"""CUDA-graph replays of the iterated update's sync-free stretches per
window over the measured window of a `--trace 1` run: the program's counter
`update.graph_replays` (limovelo_tpu_torch/filter/graphs.py).  From the
program's window log (program_log.py); a program without the counter gives
nothing."""

from lio_bench.program_log import growth


def read(ctx):
    g = growth(ctx.windows)
    if g is None or "update.graph_replays" not in g.counters:
        return None
    return g.counters["update.graph_replays"] / ctx.windows
