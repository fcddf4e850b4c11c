"""What the program records about its own recent windows, for the readers
of its `program_span` metrics: the growth of its recorder's totals
(limovelo_tpu_torch/runtime/profiling.py, `StageTimers.log`) over its last
windows.  The log is always on, so a reader needs no hook in the run.  A
program without such a log gives None, and the reader leaves its metric
out."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class Growth(NamedTuple):
    counters: Dict[str, int]
    stage_ns: Dict[str, int]   # host ns inside each stage
    wait_ns: Dict[str, int]    # host ns in the `sync.*` waits, by the stage around them


def _recorder_log():
    try:
        from limovelo_tpu_torch.runtime import profiling

        return profiling.current().log
    except (ImportError, AttributeError):
        return None


def _minus(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: v - b.get(k, 0) for k, v in a.items()}


def growth(last: int) -> Optional[Growth]:
    """The growth of the current recorder's totals over the program's last
    `last` windows (the metric is read as soon as the measured window
    closes, so they are its last windows), or None where the log does not
    reach that far back."""
    log = _recorder_log()
    if not log or last <= 0 or len(log) < last:
        return None
    end = log[-1]
    if len(log) > last:
        base = log[-1 - last]
        if end.window - base.window != last:
            return None
        b = (base.counters, base.stage_ns, base.wait_ns)
    elif end.window == last:      # the log holds every window from the first
        b = ({}, {}, {})
    else:
        return None
    return Growth(_minus(end.counters, b[0]), _minus(end.stage_ns, b[1]),
                  _minus(end.wait_ns, b[2]))
