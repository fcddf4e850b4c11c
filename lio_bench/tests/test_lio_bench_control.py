"""The comparison's control on the card: the reference computed with TF32
products, put in the program's place, must come out not correct, while the
program itself is correct (a tiny lap; the cell-size readings are in
PERF.md, from calibrate.py)."""

import time

import pytest

from lio_bench import compare
from lio_bench.cells import load, load_benchmark
from lio_bench.drive import run_cell
from lio_bench.reference.replay import replay
from lio_bench.tests.tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in load_benchmark()["workloads"]])
def test_tf32_control_is_not_correct(card, name):
    cell = tiny_cell(name, limits=load(*name.split(".", 1)).limits)
    r = run_cell(cell, seed=424242, seconds=4.0, trace=False, t_process0=time.perf_counter(),
                 device=card)
    assert r["correct"], r["checks"]
    prog, ref = r["_outputs"]
    est = "extr_gap_m" in r["checks"]
    n = r["_info"]["messages"]
    ctrl, ctrl_windows = replay(cell, r["_stream"], n, card, "tf32")
    ref32, _ = replay(cell, r["_stream"], n, card, follow=ctrl_windows)
    ok, checks = compare.judge(compare.gaps(ctrl, ref32, est), cell.limits, failed=0)
    assert not ok, checks
