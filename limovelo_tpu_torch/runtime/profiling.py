"""Tracing and profiling (port of `limovelo_tpu/runtime/profiling.py`):

- `trace(logdir)`: context manager around `torch.profiler` that captures
  the enclosed block (host ops, and the card's kernels and copies when the
  block runs on a card) and writes a Chrome trace into `logdir` (open it in
  ui.perfetto.dev or chrome://tracing).
- `annotate(name)`: a named span inside such a trace
  (`torch.profiler.record_function`).
- `StageTimers`: always-on per-stage wall timers with p50/p95 summaries.
  Host clock only: on the card a stage that merely enqueues work returns
  before the device finishes, so a stage's time is the host's share of it
  unless the stage ends in a synchronising read (the pipeline's
  `tele_read`).

CLI: `python -m limovelo_tpu_torch sim --profile DIR ...` wraps the whole
replay in `trace()`.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch


@contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into `logdir`
    (`trace.json`, Chrome trace format); the card's activity is recorded
    when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span inside a `trace()` capture."""
    return torch.profiler.record_function(name)


class StageTimers:
    """Always-on per-stage wall timers.

    >>> timers = StageTimers()
    >>> with timers("deskew"):
    ...     run_deskew()
    >>> timers.summary()   # {"deskew": {"n": 1, "p50_ms": ..., "p95_ms": ...}}
    """

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[stage].append(time.perf_counter() - t0)

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
