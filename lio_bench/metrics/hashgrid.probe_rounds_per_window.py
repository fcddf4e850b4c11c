"""Hash-table probe rounds per window over the measured window of a
`--trace 1` run: the program's counters `hashgrid.claim_rounds` (the map
insert's) and `hashgrid.lookup_rounds` (each map search's bucket lookup);
each round ends in a blocking read.  From the program's window log
(program_log.py)."""

from lio_bench.program_log import growth

ROUNDS = ("hashgrid.claim_rounds", "hashgrid.lookup_rounds")


def read(ctx):
    g = growth(ctx.windows)
    if g is None or not any(k in g.counters for k in ROUNDS):
        return None
    return sum(g.counters.get(k, 0) for k in ROUNDS) / ctx.windows
