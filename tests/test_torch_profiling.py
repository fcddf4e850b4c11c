"""The port's recorder (`limovelo_tpu_torch/runtime/profiling.py`): spans,
counters and stage timers; its clock against kineto's; the census of the
step's blocking reads against its `sync.*` counters; and the benchmark's
readers of the recorder (`lio_bench/spans.py`, `lio_bench/program_log.py`,
`lio_bench/metrics/`) on synthetic inputs.  No JAX here."""

import json

import numpy as np
import pytest
import torch

from lio_bench import spans as sp
from lio_bench import trace as tr
from lio_bench.cells import metric_reader
from lio_bench.drive import Context
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.runtime.profiling import Span, StageTimers, WindowMark

MS = 1_000_000   # ns


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_spans_nest_with_parents_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000 * MS, MS))     # each reading 1 ms after the last
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))
    rec = StageTimers()
    rec.enable()
    rec.window = 7
    with rec("step"):                      # a stage is a span too
        with rec.span("step.update"):
            with rec.blocking("sync.eigh", 2):
                pass
        with rec.span("step.insert"):
            pass
    assert [(s.name, s.parent, s.window) for s in rec.spans] == [
        ("step", -1, 7), ("step.update", 0, 7), ("sync.eigh", 1, 7), ("step.insert", 0, 7)]
    assert [s.end - s.start for s in rec.spans] == [7 * MS, 3 * MS, MS, MS]
    tot = rec.span_totals()
    assert tot["step"] == {"n": 1, "total_ms": 7.0, "self_ms": 3.0}
    assert tot["step.update"]["self_ms"] == 2.0
    assert tot["sync.eigh"]["self_ms"] == 1.0
    assert rec.counters["sync.eigh"] == 2
    assert set(rec.summary()) == {"step"}


def test_counters_are_always_on_and_spans_only_when_enabled():
    rec = StageTimers()
    assert not rec.enabled
    with rec("h2d"):
        with rec.span("x"), rec.blocking("sync.h2d"):
            rec.count("hashgrid.claim_rounds", 3)
    assert rec.spans == []
    assert dict(rec.counters) == {"sync.h2d": 1, "hashgrid.claim_rounds": 3}
    # the disabled span is one shared null context: no clock read, nothing
    # kept; a wait times itself and holds that same null span
    assert rec.span("a") is rec.span("b") is rec.blocking("sync.c").span
    assert set(rec.wait_ns) == {"h2d"} and 0 <= rec.wait_ns["h2d"] <= rec.stage_ns["h2d"]
    s = rec.summary()
    assert set(s) == {"h2d"} and set(s["h2d"]) == {"n", "p50_ms", "p95_ms", "total_ms"}
    assert s["h2d"]["n"] == 1
    assert "h2d" in rec.report()
    rec.enable()
    with rec.span("x"):
        pass
    rec.disable()
    with rec.span("y"):
        pass
    assert [s.name for s in rec.spans] == ["x"]


def test_waits_and_the_window_log_are_always_on(monkeypatch):
    """Disabled, a wait still adds its host time under the stage around it
    (a wait inside a wait adds none of its own), and each closed window logs
    the cumulative counters, stage totals and waits."""
    clock = iter(range(0, 10_000 * MS, MS))     # each reading 1 ms after the last
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    rec = StageTimers()
    for w in (1, 2):
        rec.window = w
        with rec("step"):                          # 0 .. 5
            with rec.blocking("sync.eigh", 2):     # 1 .. 4
                with rec.blocking("sync.h2d"):     # 2 .. 3
                    pass
        with rec.blocking("sync.offsets"):         # outside every stage
            pass
        rec.count("update.searches")
        rec.close_window()
    assert rec.spans == []
    assert [m.window for m in rec.log] == [1, 2]
    assert rec.log[0] == WindowMark(1, {"sync.eigh": 2, "sync.h2d": 1, "sync.offsets": 1,
                                        "update.searches": 1},
                                    {"step": 5 * MS}, {"step": 3 * MS, "": MS})
    assert rec.log[1].counters["sync.eigh"] == 4 and rec.log[1].wait_ns["step"] == 6 * MS
    assert rec.summary()["step"]["total_ms"] == pytest.approx(10.0)
    assert rec.log.maxlen == profiling.LOG_WINDOWS


def test_module_functions_reach_the_installed_recorder():
    before = profiling.current()
    try:
        rec = StageTimers()
        profiling.install(rec)
        assert profiling.current() is rec
        profiling.count("update.searches")
        profiling.count("update.searches", 2)
        rec.enable()
        with profiling.span("update.search"), profiling.blocking("sync.offsets"):
            pass
        assert rec.counters["update.searches"] == 3 and rec.counters["sync.offsets"] == 1
        assert [(s.name, s.parent) for s in rec.spans] == [("update.search", -1),
                                                          ("sync.offsets", 0)]
    finally:
        profiling.install(before)


def test_span_clock_is_kinetos():
    """A program span and a `record_function` around the same block start
    within 50 µs of each other (the median of 20) inside a CPU-activity
    profiler capture: both read the clock kineto stamps its records with."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = StageTimers()
    rec.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with rec.span("probe"), record_function("probe"):
                torch.ones(8).sum()
    kin = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "probe")
    ours = [s.start for s in rec.spans]
    assert len(kin) == len(ours) == 20
    gap_us = (np.array(kin) - np.array(ours)) / 1e3
    assert abs(np.median(gap_us)) < 50, gap_us


def test_trace_writes_the_block_spans_beside_the_profile(tmp_path):
    before = profiling.current()
    try:
        rec = StageTimers()
        profiling.install(rec)
        with profiling.trace(str(tmp_path)):
            with profiling.span("pipeline.spin"), profiling.span("step.voxel"):
                torch.ones(4).sum()
        assert not rec.enabled
        kin = json.loads((tmp_path / "trace.json").read_text())
        spans = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
        assert [e["name"] for e in spans] == ["pipeline.spin", "step.voxel"]
        # the spans' µs are on trace.json's time base: they fall among its events
        ts = [e["ts"] for e in kin["traceEvents"] if "ts" in e and e.get("ph") == "X"]
        assert min(ts) - 1e5 < spans[0]["ts"] < max(ts) + 1e5
    finally:
        profiling.install(before)


# ---------------------------------------------------------------------------
# the census: every blocking read of a window is a named site
# ---------------------------------------------------------------------------


def _is_device(v) -> bool:
    return isinstance(v, (torch.device, str)) and torch.device(v).type in ("cpu", "cuda")


def _index_reads(index) -> int:
    """Host reads an index makes on a CUDA tensor: each 0-dim integer
    tensor in it is read as a Python int, each bool tensor through
    `nonzero`."""
    parts = index if isinstance(index, (tuple, list)) else (index,)
    return sum(1 for p in parts if isinstance(p, torch.Tensor)
               and (p.dtype == torch.bool or (p.dim() == 0 and not p.is_floating_point())))


def test_every_blocking_read_of_a_window_is_a_counted_site(monkeypatch):
    """One pipeline's windows on the CPU with the calls that wait for the
    card on a CUDA tensor wrapped and counted: `bool()`, `.item()`,
    `.cpu()`, `.tolist()`, `float()`, `int()`, `operator.index`,
    `torch.nonzero`, an index by a 0-dim integer tensor or a bool tensor
    (read, set, `index_put_`), each copy of host memory to a device
    (`.to(device)`, `torch.as_tensor`/`torch.tensor` of host data with a
    `device`) and `torch.linalg.eigh` (whose error check and cuSOLVER's
    syevd each wait: `update.EIGH_READS`).  In each `step_window` their
    count equals the growth of the `sync.*` counters, and every known site
    is met."""
    from limovelo_tpu_torch.config import DEFAULT
    from limovelo_tpu_torch.filter import update
    from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    reads = {"n": 0, "on": False}

    def counted(fn, weight=lambda *a, **k: 1):
        def wrapped(*a, **k):
            if reads["on"]:
                reads["n"] += weight(*a, **k)
            return fn(*a, **k)
        return wrapped

    T = torch.Tensor
    for name in ("__bool__", "item", "cpu", "tolist", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(T, name, counted(getattr(T, name)))
    for name in ("__getitem__", "__setitem__", "index_put_"):
        monkeypatch.setattr(T, name, counted(getattr(T, name),
                                             lambda self, index, *a, **k: _index_reads(index)))
    monkeypatch.setattr(torch, "nonzero", counted(torch.nonzero))
    monkeypatch.setattr(torch.linalg, "eigh", counted(torch.linalg.eigh,
                                                      lambda *a, **k: update.EIGH_READS))
    monkeypatch.setattr(T, "to", counted(T.to, lambda self, *a, **k: int(
        "device" in k or any(_is_device(v) for v in a))))
    host = lambda data, *a, **k: int("device" in k and not isinstance(data, T))
    monkeypatch.setattr(torch, "as_tensor", counted(torch.as_tensor, host))
    monkeypatch.setattr(torch, "tensor", counted(torch.tensor, host))

    cfg = DEFAULT.replace(knn_rings=1, knn_backend="grouped", map_table_size=1 << 12,
                          min_dist=0.5, downsample_prec=0.3, imu_rate=200.0,
                          real_time_delay=0.1)
    assert cfg.static().match_mode == "auto"
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5),
                   cfg, duration=1.2, lidar_lines=8, pts_per_line=128, imu_rate=200.0)
    pipe = LioPipeline(cfg, device="cpu")
    step, per_window = pipe.step_window, []

    def census(t1, t2):
        syncs = lambda: sum(v for k, v in pipe.timers.counters.items() if k.startswith("sync."))
        c0, reads["n"], reads["on"] = syncs(), 0, True
        try:
            rec = step(t1, t2)
        finally:
            reads["on"] = False
        per_window.append((reads["n"], syncs() - c0))
        return rec

    pipe.step_window = census
    replay_into(pipe, sim)
    assert len(pipe.result.records) >= 5
    assert all(n == c > 0 for n, c in per_window), per_window
    sites = {k for k, v in pipe.timers.counters.items() if k.startswith("sync.") and v}
    assert sites == {"sync.h2d", "sync.eigh", "sync.refresh", "sync.offsets",
                     "sync.lookup_round", "sync.claim_round", "sync.insert_nonzero",
                     "sync.anchor_controls", "sync.state_at", "sync.tele_read"}
    c = pipe.timers.counters
    assert c["hashgrid.claim_rounds"] > 0 and c["hashgrid.lookup_rounds"] > 0
    assert c["update.searches"] >= len(per_window)
    assert c["sync.tele_read"] == len(per_window) == pipe.timers.window
    assert [m.window for m in pipe.timers.log] == list(range(1, len(per_window) + 1))
    # the log's last mark holds every total but the spins after the last
    # window, which found no window
    after = {k: v - pipe.timers.log[-1].counters.get(k, 0) for k, v in c.items()}
    assert {k for k, v in after.items() if v} == {"pipeline.idle_spins"}
    assert after["pipeline.idle_spins"] > 0


def test_a_window_records_its_stage_and_step_spans():
    """With the recorder enabled, one window's spans nest as the layers do:
    the stages under `pipeline.spin`, the step's stages under `step`, the
    searches under `step.update`, and each span carries its window."""
    from limovelo_tpu_torch.config import DEFAULT
    from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    cfg = DEFAULT.replace(knn_rings=1, knn_backend="grouped", map_table_size=1 << 12,
                          min_dist=0.5, downsample_prec=0.3, imu_rate=200.0,
                          real_time_delay=0.1)
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5),
                   cfg, duration=1.0, lidar_lines=8, pts_per_line=96, imu_rate=200.0)
    pipe = LioPipeline(cfg, device="cpu")
    pipe.timers.enable()
    replay_into(pipe, sim)
    spans = pipe.timers.spans
    parent = lambda s: spans[s.parent].name if s.parent >= 0 else None
    by = {}
    for s in spans:
        by.setdefault(s.name, set()).add(parent(s))
    assert by["pipeline.spin"] == {None} and by["ingest.add_scan"] == {None}
    for stage in ("assemble", "h2d", "step", "tele_read", "resolve_host"):
        assert by[stage] == {"pipeline.spin"}, stage
    for stage in ("step.predict", "step.deskew", "step.voxel", "step.update", "step.insert",
                  "step.telemetry"):
        assert by[stage] == {"step"}, stage
    assert by["update.search"] <= {"step.update", "update.iteration"}
    assert by["knn.group"] == by["knn.kernel"] == by["knn.gather"] == {"update.search"}
    assert by["hashgrid.lookup"] == {"knn.group"} and by["hashgrid.claim"] == {"step.insert"}
    assert by["sync.tele_read"] == {"tele_read"} and by["sync.h2d"] == {"h2d"}
    assert by["update.covariance"] == {"step.update"}
    steps = [s for s in spans if s.name == "step"]
    assert [s.window for s in steps] == list(range(1, pipe.timers.window + 1))
    tot = pipe.timers.span_totals()
    assert 0 < tot["step"]["self_ms"] < tot["step"]["total_ms"]


# ---------------------------------------------------------------------------
# the benchmark's readers of the recorder
# ---------------------------------------------------------------------------


def _events():
    """Device work [0,2] [6,7] [9,10] ms, issued by the host thread's calls
    (correlation ids 1, 3, 4); an idle gap [2,6] ms inside the host's copy
    call and one [7,9] ms between calls; a profiler thread's call."""
    E = sp.CEv
    return [
        E("k1", "kernel", 0, 2 * MS, 0, 1), E("Memcpy DtoH", "memcpy", 6 * MS, 7 * MS, 0, 3),
        E("k3", "kernel", 9 * MS, 10 * MS, 0, 4),
        E("cudaLaunchKernel", "runtime", 0, 1000, 1, 1),
        E("cudaMemcpyAsync", "runtime", 3 * MS, 6 * MS + MS // 2, 1, 3),
        E("cudaLaunchKernel", "runtime", 8 * MS + MS // 2, 9 * MS, 1, 4),
        E("cudaStreamSynchronize", "runtime", 9 * MS + 20, 10 * MS, 1, 5),
        E("cudaEventQuery", "runtime", 7 * MS, 9 * MS, 2, 6),
    ]


def _spans():
    """`step` over [0, 8.2] ms holding `step.update` [0, 3.5] (in it
    `sync.eigh` [2.5, 3.5]) and `sync.tele_read` [3.6, 8.1]; the launch at
    8.5 ms lies under no span."""
    return [Span("step", -1, 0, 8 * MS + MS // 5, 1),
            Span("step.update", 0, 0, 3 * MS + MS // 2, 1),
            Span("sync.eigh", 1, 2 * MS + MS // 2, 3 * MS + MS // 2, 1),
            Span("sync.tele_read", 0, 3 * MS + 600_000, 8 * MS + 100_000, 1)]


def test_idle_and_device_time_by_span_on_a_synthetic_trace():
    ev, spans = _events(), _spans()
    # gaps [2,6] (middle 4: inside sync.tele_read) and [7,9] (middle 8: the same)
    assert dict(sp.idle_by_span(ev, spans)) == {"sync.tele_read": pytest.approx(0.006)}
    assert sum(v for _, v in sp.idle_by_span(ev, spans)) == pytest.approx(
        sum(v for _, v in tr.idle_by_host(ev)))
    late = [s._replace(end=min(s.end, 7 * MS + MS // 2)) for s in spans]
    assert dict(sp.idle_by_span(ev, late)) == {"sync.tele_read": pytest.approx(0.004),
                                               sp.NO_SPAN: pytest.approx(0.002)}
    # k1 issued at 0 ms (in step.update), the copy at 3 ms (in sync.eigh),
    # k3 at 8.5 ms (after every span closed)
    assert dict(sp.device_by_span(ev, spans)) == {
        "step.update": pytest.approx(0.002), "sync.eigh": pytest.approx(0.001),
        sp.NO_SPAN: pytest.approx(0.001)}
    orphan = [e._replace(corr=99) if e.name == "k3" else e for e in ev]
    assert dict(sp.device_by_span(orphan, spans))[sp.NO_CALL] == pytest.approx(0.001)
    assert sp.idle_by_span(ev, []) == [] and sp.device_by_span(ev, []) == []


def test_tele_read_end_against_its_copy_on_a_synthetic_trace():
    """Only a copy issued inside `sync.tele_read` [3.6, 8.1] ms counts: the
    one issued at 3 ms does not; issued at 4 ms, its device end at 7 ms lies
    1.1 ms before the span's end."""
    ev, spans = _events(), _spans()
    assert sp.tele_read_after_copy_us(ev, spans) == []
    ev = [e._replace(start=4 * MS) if e.name == "cudaMemcpyAsync" else e for e in ev]
    assert sp.tele_read_after_copy_us(ev, spans) == [pytest.approx(1100.0)]


def _ctx(**kw):
    base = dict(setup_s=12.5, windows=40, window_s=8.0, step_s=[0.1] * 40,
                device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return Context(**base)


def _installed_log(monkeypatch, marks):
    rec = StageTimers()
    rec.log.extend(marks)
    monkeypatch.setattr(profiling, "_current", rec)


def test_program_span_readers_on_a_synthetic_context(monkeypatch):
    """Set-up windows 1-2, measured windows 3-6 (3-4 traced, 5-6 after the
    trace).  Over windows 5-6: `step` 20 ms holding 4 ms of waits, and 6 ms
    of waits in other stages; over windows 3-6, 32 probe rounds and 6
    searches."""
    def mark(w, step, wait_step, wait_other, rounds, searches):
        return WindowMark(w, {"hashgrid.claim_rounds": rounds // 4,
                              "hashgrid.lookup_rounds": rounds - rounds // 4,
                              "update.searches": searches, "sync.eigh": 8 * w},
                          {"step": step * MS, "h2d": w * MS},
                          {"step": wait_step * MS, "tele_read": wait_other * MS})
    _installed_log(monkeypatch, [mark(1, 10, 1, 1, 40, 1), mark(2, 20, 2, 2, 48, 2),
                                 mark(3, 30, 3, 3, 56, 3), mark(4, 40, 4, 4, 64, 5),
                                 mark(5, 50, 6, 7, 72, 6), mark(6, 60, 8, 10, 80, 8)])
    ctx = _ctx(windows=4, host_windows=2)
    assert metric_reader("step.dispatch_ms")(ctx) == pytest.approx((20 - 4) / 2)
    assert metric_reader("step.blocked_ms")(ctx) == pytest.approx((4 + 6) / 2)
    assert metric_reader("hashgrid.probe_rounds_per_window")(ctx) == pytest.approx(32 / 4)
    assert metric_reader("update.searches_per_window")(ctx) == pytest.approx(6 / 4)
    # a log that holds every window from the first reads from zero
    assert metric_reader("update.searches_per_window")(_ctx(windows=6)) == pytest.approx(8 / 6)
    # a log that does not reach back far enough, or skips a window, reads nothing
    assert metric_reader("update.searches_per_window")(_ctx(windows=7)) is None
    _installed_log(monkeypatch, [mark(1, 10, 1, 1, 40, 1), mark(3, 30, 3, 3, 56, 3),
                                 mark(4, 40, 4, 4, 64, 5)])
    assert metric_reader("update.searches_per_window")(_ctx(windows=2)) is None


def test_program_span_readers_return_nothing_without_a_recorder(monkeypatch):
    """A run of a program without the window log (or without a trace)
    leaves the four metrics out."""
    names = ("step.dispatch_ms", "step.blocked_ms", "hashgrid.probe_rounds_per_window",
             "update.searches_per_window")
    _installed_log(monkeypatch, [])
    for name in names:
        assert metric_reader(name)(_ctx(host_windows=3)) is None
    monkeypatch.delattr(profiling, "current")
    for name in names:
        assert metric_reader(name)(_ctx(host_windows=3)) is None
