"""What the traced run reads from `torch.profiler`: the events as plain
tuples, the device's busy time, and the breakdown (the device operations
that took most time, and the device's idle time by what the host was doing).

An event's `kind` is one of
- "kernel", "memcpy", "memset": work on the device;
- "runtime": a CUDA runtime or driver call on the host (launches, syncs,
  copies).

The profiler records CUDA activity alone (drive.Tracer), so host operators
do not appear.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_KINDS = ("kernel", "memcpy", "memset")
_ACTIVITY = {
    "kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
    "cuda_runtime": "runtime", "cuda_driver": "runtime",
}
#: device-side shadows of host spans, and profiler bookkeeping: not work
_SKIP = ("gpu_user_annotation", "overhead")


class Ev(NamedTuple):
    name: str
    kind: str
    start: int   # ns
    end: int     # ns
    tid: int


def _kind(e) -> Optional[str]:
    act = getattr(e, "activity_type", None)
    act = act() if callable(act) else None
    name = e.name()
    if act in _SKIP:
        return None
    on_device = str(e.device_type()).endswith("CUDA")
    if on_device:
        if act in _ACTIVITY and _ACTIVITY[act] in DEVICE_KINDS:
            return _ACTIVITY[act]
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    if act in _ACTIVITY and _ACTIVITY[act] not in DEVICE_KINDS:
        return _ACTIVITY[act]
    if name.startswith(("cuda", "cu")):
        return "runtime"
    return None


def events_from_profiler(prof) -> List[Ev]:
    """The profiler's events (kineto's records, read without building the
    profiler's own tables)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        start = int(e.start_ns())
        out.append(Ev(e.name(), kind, start, start + int(e.duration_ns()),
                      int(e.start_thread_id())))
    return out


def device_intervals(events: List[Ev]) -> List[Tuple[int, int]]:
    """The device's busy intervals, merged."""
    iv = sorted((e.start, e.end) for e in events if e.kind in DEVICE_KINDS)
    merged: List[Tuple[int, int]] = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    return merged


def busy_seconds(events: List[Ev]) -> float:
    return sum(t - s for s, t in device_intervals(events)) / 1e9


def top_device_ops(events: List[Ev], n: int = 10) -> List[list]:
    """[[name, seconds], ...] of the device operations with most time."""
    acc: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.kind in DEVICE_KINDS:
            acc[e.name[:120]] += e.end - e.start
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def _host_tid(events: List[Ev]) -> Optional[int]:
    """The thread that made most runtime calls: the one that drives the
    program."""
    tids = [e.tid for e in events if e.kind == "runtime"]
    return max(set(tids), key=tids.count) if tids else None


def idle_by_host(events: List[Ev], n: int = 10) -> List[list]:
    """[[label, seconds], ...]: the device's idle time inside the traced
    span, summed by the CUDA runtime call the host thread was in at the
    middle of each gap ("host" where it was in none: Python and the CPU's
    own work between calls)."""
    busy = device_intervals(events)
    tid = _host_tid(events)
    calls = sorted(((e.start, e.end, e.name) for e in events
                    if e.kind == "runtime" and e.tid == tid))
    if not busy or not calls:
        return []
    lo, hi = calls[0][0], max(c[1] for c in calls)
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    starts = [c[0] for c in calls]
    acc: Dict[str, int] = defaultdict(int)
    for a, b in gaps:
        q = (a + b) // 2
        i = bisect.bisect_right(starts, q) - 1
        # runtime calls on one thread do not nest: the last to start is the only candidate
        label = calls[i][2] if i >= 0 and calls[i][1] >= q else "host"
        acc[label] += b - a
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]
