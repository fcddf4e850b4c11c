"""Per-stage wall timers (port of `StageTimers` in
`limovelo_tpu/runtime/profiling.py`).

Host clock only: on the card a stage that merely enqueues work returns
before the device finishes, so a stage's time is the host's share of it
unless the stage ends in a synchronising read (the pipeline's `tele_read`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


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
