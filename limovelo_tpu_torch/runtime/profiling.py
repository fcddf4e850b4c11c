"""Tracing and profiling (port of `limovelo_tpu/runtime/profiling.py`): one
recorder, `StageTimers`, and the process-wide handle that reaches it.

- `StageTimers` (the recorder):
  - always-on per-stage wall timers with p50/p95 summaries
    (`with timers("h2d"): ...`, or `record(stage, start, end)` for a stage
    known only once it has ended; `summary()`, `report()`).  Host clock only:
    on the card a stage that merely enqueues work returns before the device
    finishes, so a stage's time is the host's share of it unless the stage
    ends in a synchronising read (the pipeline's `tele_read`);
  - always-on named integer counters (`count`, `counters`);
  - always-on waits: `blocking("sync.<site>")` marks a place where the host
    waits for the device (a read of a device value, a copy of pageable host
    memory to the card).  It counts the waits under the site's name and
    adds the block's host time to `wait_ns`, under the innermost stage open
    around it (`step`, `h2d`, `tele_read`, ...);
  - always-on `log`: the cumulative counters, stage totals and waits at the
    close of each of the last LOG_WINDOWS windows (`close_window`), so a
    reader takes their growth over any run of recent windows;
  - while `enable()`d, spans: each `span(name)` block, each stage and each
    wait is kept in memory as a `Span` (name, parent, start ns, end ns,
    window).  Start and end are `time.time_ns()`, the clock kineto stamps
    its records with, so program spans and the profiler's CUPTI records
    share one timeline.  Spans time host work: nothing here waits for the
    device.  Disabled, `span()` returns one shared null context: no clock
    read, nothing stored.
- `install(recorder)` makes a recorder the current one (`LioPipeline`
  installs its `timers`); `current()`, `span(name)`, `count(name, n)` and
  `blocking(name)` reach it from code that has no pipeline handle.
- `trace(logdir)`: `torch.profiler` around the enclosed block (host ops,
  and the card's kernels and copies when the block runs on a card), with
  the current recorder enabled; writes `trace.json` and the block's
  program spans as `spans.json` (Chrome trace events on trace.json's time
  base), for ui.perfetto.dev or chrome://tracing.

CLI: `python -m limovelo_tpu_torch sim --profile DIR ...` wraps the whole
replay in `trace()`.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, NamedTuple

import numpy as np
import torch


class Span(NamedTuple):
    name: str
    parent: int   # index in `StageTimers.spans` of the enclosing span; -1 at the top
    start: int    # ns, time.time_ns()
    end: int      # ns
    window: int   # `StageTimers.window` when the span closed


class WindowMark(NamedTuple):
    """The recorder's cumulative totals at the close of a window."""

    window: int
    counters: Dict[str, int]
    stage_ns: Dict[str, int]   # host ns inside each stage
    wait_ns: Dict[str, int]    # host ns waiting for the device, by the stage around the wait


#: windows the recorder's `log` keeps
LOG_WINDOWS = 2048

_NULL = contextlib.nullcontext()


class _Open:
    """One span being recorded; its slot in `spans` is taken at entry, so a
    parent's index is known to its children."""

    __slots__ = ("rec", "name", "i", "parent", "t0")

    def __init__(self, rec: "StageTimers", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent, self.i = rec._open, len(rec.spans)
        rec.spans.append(None)
        rec._open = self.i
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec.spans[self.i] = Span(self.name, self.parent, self.t0, t1, rec.window)
        rec._open = self.parent
        return False


class _Wait:
    """One blocking site being timed (and recorded as a span while the
    recorder is enabled).  A wait inside another adds no time of its own."""

    __slots__ = ("rec", "span", "t0")

    def __init__(self, rec: "StageTimers", name: str):
        self.rec, self.span = rec, rec.span(name)

    def __enter__(self):
        self.rec._waiting += 1
        self.span.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.span.__exit__(*exc)
        rec = self.rec
        rec._waiting -= 1
        if not rec._waiting:
            rec.wait_ns[rec._stage] += dt
        return False


class StageTimers:
    """The recorder: always-on stage timers, counters, waits and window
    log; spans while enabled.

    >>> timers = StageTimers()
    >>> with timers("deskew"):
    ...     run_deskew()
    >>> timers.summary()   # {"deskew": {"n": 1, "p50_ms": ..., "p95_ms": ...}}
    >>> timers.enable()
    >>> with timers.span("step.voxel"):
    ...     downsample()
    >>> timers.spans       # [Span("step.voxel", -1, start, end, 0)]
    """

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, int] = defaultdict(int)
        self.stage_ns: Dict[str, int] = defaultdict(int)
        self.wait_ns: Dict[str, int] = defaultdict(int)
        self.log: Deque[WindowMark] = deque(maxlen=LOG_WINDOWS)
        self.spans: List[Span] = []
        #: the window a span belongs to (the pipeline counts its windows here)
        self.window = 0
        self.enabled = False
        self._open = -1
        self._stage = ""      # the innermost stage open
        self._waiting = 0     # waits open

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @contextlib.contextmanager
    def __call__(self, stage: str):
        outer, self._stage = self._stage, stage
        t0 = time.perf_counter_ns()
        try:
            with self.span(stage):
                yield
        finally:
            self._stage = outer
            self._add(stage, time.perf_counter_ns() - t0)

    def record(self, stage: str, start: int, end: int) -> None:
        """A stage its caller timed itself (`time.time_ns()` at its start
        and end), for a stage known only once it has ended: a pipeline pass
        is `spin_idle` when it found no window.  Kept as a span while
        enabled, inside the span open around it."""
        self._add(stage, end - start)
        if self.enabled:
            self.spans.append(Span(stage, self._open, start, end, self.window))

    def _add(self, stage: str, dt_ns: int) -> None:
        self._samples[stage].append(dt_ns / 1e9)
        self.stage_ns[stage] += dt_ns

    def span(self, name: str):
        return _Open(self, name) if self.enabled else _NULL

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def blocking(self, name: str, n: int = 1):
        """A place where the host waits for the device `n` times: counts
        the waits under `name` and returns the block's timer."""
        self.counters[name] += n
        return _Wait(self, name)

    def close_window(self) -> None:
        """Log the totals at the close of window `window`."""
        self.log.append(WindowMark(self.window, dict(self.counters), dict(self.stage_ns),
                                   dict(self.wait_ns)))

    def span_totals(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total and self ms (self = a span's duration
        minus what its child spans cover)."""
        total: Dict[str, int] = defaultdict(int)
        own: Dict[str, int] = defaultdict(int)
        n: Dict[str, int] = defaultdict(int)
        for s in self.spans:
            if s is None:       # still open
                continue
            d = s.end - s.start
            n[s.name] += 1
            total[s.name] += d
            own[s.name] += d
            if s.parent >= 0 and self.spans[s.parent] is not None:
                own[self.spans[s.parent].name] -= d
        return {k: {"n": n[k], "total_ms": total[k] / 1e6, "self_ms": own[k] / 1e6}
                for k in n}

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, xs in self._samples.items():
            a = np.asarray(xs) * 1e3
            out[stage] = {
                "n": len(xs),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "total_ms": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = [f"{'stage':16s} {'n':>6s} {'p50 ms':>9s} {'p95 ms':>9s} {'total ms':>10s}"]
        for stage, s in sorted(self.summary().items()):
            rows.append(
                f"{stage:16s} {s['n']:6d} {s['p50_ms']:9.3f} "
                f"{s['p95_ms']:9.3f} {s['total_ms']:10.1f}"
            )
        return "\n".join(rows)


#: the recorder `span`, `count` and `blocking` reach (until a pipeline
#: installs its own)
_current = StageTimers()


def install(recorder: StageTimers) -> None:
    global _current
    _current = recorder


def current() -> StageTimers:
    return _current


def span(name: str):
    """A span of the current recorder (the shared null context while it is
    disabled)."""
    return _current.span(name)


def count(name: str, n: int = 1) -> None:
    _current.counters[name] += n


def blocking(name: str, n: int = 1):
    """`StageTimers.blocking` of the current recorder."""
    return _current.blocking(name, n)


def write_spans(spans: List[Span], path: str, base_ns: int = 0) -> None:
    """Spans as Chrome trace events ("X", µs from `base_ns`) on this thread."""
    pid, tid = os.getpid(), threading.get_native_id()
    events = [{"name": s.name, "ph": "X", "cat": "program", "pid": pid, "tid": tid,
               "ts": (s.start - base_ns) / 1e3, "dur": (s.end - s.start) / 1e3,
               "args": {"window": s.window}}
              for s in spans if s is not None]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into `logdir`
    (`trace.json`, Chrome trace format; the card's activity is recorded when
    a card is present), with the current recorder enabled: its spans of the
    block go to `spans.json` on the same time base."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    rec = _current
    n0, was = len(rec.spans), rec.enabled
    rec.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        rec.enabled = was
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    # kineto writes its time base in the header, before the events
    with open(path, "rb") as f:
        m = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 16))
    write_spans(rec.spans[n0:], os.path.join(logdir, "spans.json"), int(m.group(1)) if m else 0)
