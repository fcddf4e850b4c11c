"""The reader of `update.graph_replays_per_window` on synthetic window
logs: the counter's growth per window over the measured window, and nothing
from a program whose log has no `update.graph_replays` counter."""

import pytest

from lio_bench.cells import metric_reader
from lio_bench.drive import Context
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.runtime.profiling import StageTimers, WindowMark


@pytest.fixture
def recorder():
    was = profiling.current()
    rec = StageTimers()
    profiling.install(rec)
    yield rec
    profiling.install(was)


def _ctx(windows):
    return Context(setup_s=12.5, windows=windows, window_s=8.0, step_s=[0.1] * windows,
                   device_kind="NVIDIA H100 80GB HBM3")


def _mark(w, replays, captures):
    return WindowMark(w, {"update.graph_replays": replays, "update.graph_captures": captures,
                          "update.searches": w}, {}, {})


def test_growth_per_window_over_the_measured_window(recorder):
    # set-up windows 1-2 record and replay; measured windows 3-6 replay 14 a window
    recorder.log.extend([_mark(1, 7, 7), _mark(2, 21, 7), _mark(3, 35, 7), _mark(4, 49, 7),
                         _mark(5, 63, 7), _mark(6, 77, 7)])
    read = metric_reader("update.graph_replays_per_window")
    assert read(_ctx(4)) == pytest.approx(56 / 4)
    # from the first window on, the whole totals
    assert read(_ctx(6)) == pytest.approx(77 / 6)
    # a log that does not reach that far back
    assert read(_ctx(7)) is None


def test_nothing_without_the_counter(recorder):
    recorder.log.extend([WindowMark(w, {"update.searches": w}, {}, {}) for w in range(1, 7)])
    assert metric_reader("update.graph_replays_per_window")(_ctx(4)) is None
