"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have (faults.py), under each cell's committed
limits; the harness's look for a chip is skipped (CPU, tiny lap)."""

import time

import pytest

from lio_bench.cells import load, load_benchmark
from lio_bench.drive import run_cell
from lio_bench.faults import KINDS, planted
from lio_bench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, kind):
    cell = tiny_cell(name, limits=load(*name.split(".", 1)).limits)
    with planted(kind):
        r = run_cell(cell, seed=31337, seconds=1.5, trace=False,
                     t_process0=time.perf_counter(), device="cpu")
    assert not r["correct"], r["checks"]
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in r["checks"].values())
