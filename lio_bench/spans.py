#!/usr/bin/env python3
"""The device trace by the program's own spans.

    python3 lio_bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does, with the program's recorder
(limovelo_tpu_torch/runtime/profiling.py) enabled over the traced windows,
and prints after run.py's lines one more JSON object, `spans`:

- `idle_by_span`: the card's idle time in the traced windows, summed by the
  innermost program span open on the host thread at the middle of each gap
  (NO_SPAN where none was open);
- `device_by_span`: the device time of each kernel, copy and fill, summed by
  the span open when the runtime call that issued it started (matched by
  CUPTI's correlation id);
- `self_ms_per_window`: each span's host time less its child spans';
- `syncs_counted_per_window`: the program's `sync.*` counts beside the
  trace's blocking calls (`step.syncs_per_window`);
- `tele_read_after_copy_us`: how long after the device end of the copy it
  waited for each `sync.tele_read` span ends (the shared clock, checked).

Spans are stamped with `time.time_ns()`, the clock of kineto's records, so
both lie on one timeline.  The recorder costs host time while enabled:
compare `run.traced_ms_per_window` with a plain `run.py --trace 1` run.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parent.parent

NO_SPAN = "(no span)"
NO_CALL = "(no runtime call)"


class CEv(NamedTuple):
    """A profiler event (lio_bench/trace.py's `Ev`) with its correlation id:
    a device operation's is that of the runtime call that issued it."""

    name: str
    kind: str
    start: int
    end: int
    tid: int
    corr: int


def events_with_corr(prof) -> List[CEv]:
    from lio_bench import trace as tr

    out = []
    for e in prof.profiler.kineto_results.events():
        kind = tr._kind(e)
        if kind is None:
            continue
        start = int(e.start_ns())
        out.append(CEv(e.name(), kind, start, start + int(e.duration_ns()),
                       int(e.start_thread_id()), int(e.correlation_id())))
    return out


def innermost(spans: list):
    """time (ns) → the name of the innermost span open then, or NO_SPAN.
    `spans` are in the order they opened (the recorder's list), each with
    its parent's index."""
    starts = [s.start for s in spans]

    def at(q: int) -> str:
        i = bisect.bisect_right(starts, q) - 1
        # the last span to open before q, or its nearest ancestor still open
        while i >= 0 and spans[i].end <= q:
            i = spans[i].parent
        return spans[i].name if i >= 0 else NO_SPAN

    return at


def _top(acc: Dict[str, int], n: int) -> List[list]:
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def idle_by_span(events: List[CEv], spans: list, n: int = 15) -> List[list]:
    """[[span, seconds], ...]: the gaps `trace.idle_by_host` sums, by the
    innermost program span open at the middle of each gap."""
    from lio_bench import trace as tr

    busy = tr.device_intervals(events)
    tid = tr._host_tid(events)
    calls = [(e.start, e.end) for e in events if e.kind == "runtime" and e.tid == tid]
    if not busy or not calls or not spans:
        return []
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    label = innermost(spans)
    acc: Dict[str, int] = defaultdict(int)
    prev = lo
    for s, t in busy + [(hi, hi)]:
        if s > prev:
            acc[label((prev + s) // 2)] += s - prev
        prev = max(prev, t)
    return _top(acc, n)


def device_by_span(events: List[CEv], spans: list, n: int = 15) -> List[list]:
    """[[span, seconds], ...]: device time by the innermost span open when
    the runtime call that issued the work started (NO_CALL where the trace
    holds no call of its correlation id)."""
    from lio_bench import trace as tr

    if not spans:
        return []
    issued = {e.corr: e.start for e in events if e.kind == "runtime" and e.corr}
    label = innermost(spans)
    acc: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.kind in tr.DEVICE_KINDS:
            t = issued.get(e.corr) if e.corr else None
            acc[label(t) if t is not None else NO_CALL] += e.end - e.start
    return _top(acc, n)


def tele_read_after_copy_us(events: List[CEv], spans: list) -> List[float]:
    """For each `sync.tele_read` span: its end less the device end of the
    last device-to-host copy issued inside it, µs."""
    issued = {e.corr: e.start for e in events if e.kind == "runtime" and e.corr}
    copies = sorted((issued[e.corr], e.end) for e in events
                    if e.kind == "memcpy" and "DtoH" in e.name and e.corr in issued)
    starts = [c[0] for c in copies]
    out = []
    for s in spans:
        if s.name != "sync.tele_read":
            continue
        i = bisect.bisect_right(starts, s.end) - 1
        if i >= 0 and copies[i][0] >= s.start:
            out.append((s.end - copies[i][1]) / 1e3)
    return out


def main(argv=None) -> int:
    import json

    sys.path.insert(0, str(ROOT))
    from lio_bench import drive, run
    from lio_bench.cells import metric_reader
    from lio_bench import trace as tr

    tracers = []

    class SpanTracer(drive.Tracer):
        """drive.Tracer with the program's recorder enabled over the traced
        windows."""

        def start(self):
            tracers.append(self)
            self.rec = self.loop.pipe.timers
            self.rec.enable()
            self.c0 = dict(self.rec.counters)
            super().start()

        def stop(self):
            super().stop()
            self.rec.disable()
            self.c1 = dict(self.rec.counters)

        def events(self):
            self.cevents = events_with_corr(self.prof)
            return super().events()

    drive.Tracer = SpanTracer
    args = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(args + ["--trace", "1"])
    if rc or not tracers:
        return rc or 2
    t = tracers[0]
    spans = [s for s in t.rec.spans if s is not None]
    ev, w = t.cevents, max(t.windows, 1)
    counted = {k: (v - t.c0.get(k, 0)) / w for k, v in sorted(t.c1.items())
               if k.startswith("sync.") and v != t.c0.get(k, 0)}
    ctx = drive.Context(setup_s=0.0, windows=t.windows, window_s=t.seconds, step_s=[],
                        device_kind="", events=[tr.Ev(*e[:5]) for e in ev],
                        traced_windows=t.windows, traced_s=t.seconds)
    own = sorted(t.rec.span_totals().items(), key=lambda kv: -kv[1]["self_ms"])[:15]
    after = tele_read_after_copy_us(ev, spans)
    out = {
        "traced_windows": t.windows, "spans": len(spans),
        "idle_s": sum(v for _, v in tr.idle_by_host(ev, n=10 ** 6)),
        "idle_by_span": idle_by_span(ev, spans),
        "device_by_span": device_by_span(ev, spans),
        "self_ms_per_window": [[k, v["self_ms"] / w] for k, v in own],
        "syncs_counted_per_window": sum(counted.values()),
        "syncs_traced_per_window": metric_reader("step.syncs_per_window")(ctx),
        "sync_sites_per_window": counted,
        "tele_read_after_copy_us": [min(after), max(after)] if after else None,
        "tele_read_spans": len(after),
    }
    print(json.dumps({"spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
