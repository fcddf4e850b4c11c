"""Every cell of BENCHMARK.json resolves to its files, every metric to its
reader, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from lio_bench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert cell.config_name + "." + cell.traffic == name
    assert cell.mix["mapping"] in ("online", "offline", "none")
    assert cell.limits["windows_mismatch"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "windows_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for spec in (cell.config, cell.mix):
        json.dumps(spec)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(cells.metric_reader(metric))


def test_unknown_cell_and_reader_are_refused():
    with pytest.raises(KeyError):
        cells.resolve("no_such.cell")
    with pytest.raises(FileNotFoundError):
        cells.metric_reader("no_such.metric")


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lio_bench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"lio_bench/configs/{c['name']}.json"
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
