"""The reader of `pipeline.idle_spin_ms` on synthetic window logs: nothing
from a program whose log has no `spin_idle` stage, else the stage's growth
per window over the windows after the trace."""

import pytest

from lio_bench.cells import metric_reader
from lio_bench.drive import Context
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.runtime.profiling import StageTimers, WindowMark

MS = 1_000_000   # ns


@pytest.fixture
def recorder():
    was = profiling.current()
    rec = StageTimers()
    profiling.install(rec)
    yield rec
    profiling.install(was)


def _ctx(host_windows):
    return Context(setup_s=10.0, windows=40, window_s=3.0, step_s=[0.07] * 40,
                   device_kind="NVIDIA H100 80GB HBM3", host_windows=host_windows)


def _log(rec, stage_ms_at_close):
    for w, stages in enumerate(stage_ms_at_close, start=1):
        rec.log.append(WindowMark(w, {"pipeline.idle_spins": 4 * w},
                                  {k: int(v * MS) for k, v in stages.items()}, {}))


def test_nothing_without_the_stage(recorder):
    _log(recorder, [{"step": 70.0 * w} for w in range(1, 7)])
    assert metric_reader("pipeline.idle_spin_ms")(_ctx(4)) is None


def test_nothing_without_the_windows(recorder):
    _log(recorder, [{"spin_idle": 0.5 * w} for w in range(1, 4)])
    assert metric_reader("pipeline.idle_spin_ms")(_ctx(0)) is None
    assert metric_reader("pipeline.idle_spin_ms")(_ctx(5)) is None


def test_growth_per_window_over_the_last_windows(recorder):
    # six windows; the idle spins before windows 3..6 took 0.2, 0.3, 0.5, 0.6 ms
    totals = [0.1, 0.3, 0.5, 0.8, 1.3, 1.9]
    _log(recorder, [{"step": 70.0 * w, "spin_idle": t} for w, t in enumerate(totals, 1)])
    got = metric_reader("pipeline.idle_spin_ms")(_ctx(4))
    assert got == pytest.approx((1.9 - 0.3) / 4)
    # from the first window on, the whole totals
    assert metric_reader("pipeline.idle_spin_ms")(_ctx(6)) == pytest.approx(1.9 / 6)
