"""The plain reference against the program on the CPU, on a tiny lap: the
run is correct and every gap is nought (the CPU is deterministic, and the
reference is a copy of the program's plain path)."""

import time

import pytest

from lio_bench.cells import load_benchmark
from lio_bench.drive import run_cell
from lio_bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", [w["name"] for w in load_benchmark()["workloads"]])
def test_reference_agrees_with_the_program_on_the_cpu(name):
    r = run_cell(tiny_cell(name), seed=2 ** 31 + 5, seconds=1.5, trace=False,
                 t_process0=time.perf_counter(), device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    numbers = {k: v["value"] for k, v in r["checks"].items()}
    assert all(v == 0.0 for v in numbers.values()), numbers
    prog, ref = r["_outputs"]
    assert len(prog.t2) == len(ref.t2) > r["_info"]["setup_windows"]
    assert len(prog.rec_t) > 0
