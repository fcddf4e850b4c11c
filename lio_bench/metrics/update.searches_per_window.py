"""Map searches per window over the measured window of a `--trace 1` run:
the program's counter `update.searches` (the update's first search and
each "auto" refresh that searched again).  From the program's window log
(program_log.py)."""

from lio_bench.program_log import growth


def read(ctx):
    g = growth(ctx.windows)
    if g is None or "update.searches" not in g.counters:
        return None
    return g.counters["update.searches"] / ctx.windows
