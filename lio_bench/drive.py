"""One run of a cell: set-up, the measured window, the check, the result.

The program (`limovelo_tpu_torch`) is driven as a ROS node drives it: each
message goes to `LioPipeline.add_imu` / `add_scan` (a scan through the
port's own Velodyne decode, `io/pointcloud.decode_scan`), and after each
scan, and with `feed.spin_every_imu` after each IMU sample, `spin_once` is
called until it processes no window (`LioPipeline.spin`).  The loop is
closed: the next message goes in as soon as the last spin returns.

Set-up renders the stream, builds the kernels and feeds the ramp from
standing.  The measured window then replays laps for `seconds`.  With
`trace`, `torch.profiler` records the first TRACE_WINDOWS windows of it
(Tracer).
Afterwards the reference replays the same messages (reference/replay.py),
following the program window by window from the program's state, and
compare.py decides `correct`.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, trace as tr
from .cells import Cell, build_config, make_stream, metric_reader

#: windows the traced run records at the start of its measured window
TRACE_WINDOWS = 30
#: top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "limovelo_tpu")
#: program stages that are host work (runtime/profiling.StageTimers)
HOST_STAGES = ("assemble", "h2d", "resolve_host")


@dataclass
class Context:
    """What a metric's reader (metrics/<name>.py) reads."""

    setup_s: float
    windows: int                      # processed in the measured window
    window_s: float                   # its wall time
    step_s: List[float]               # each window's spin_once, host clock
    device_kind: str
    # the traced run (--trace 1): the profiled windows
    events: Optional[List[tr.Ev]] = None
    traced_windows: int = 0
    traced_s: float = 0.0
    busy_s: float = 0.0
    knn_calls: list = field(default_factory=list)
    # ... and the untraced windows after them
    host_windows: int = 0
    host_stage_ms: Dict[str, float] = field(default_factory=dict)
    host_harness_s: float = 0.0


class Loop:
    """Feeds the stream's messages into a pipeline, from message `m` on."""

    def __init__(self, pipe, cfg, stream, spin_every_imu: bool, decode_scan):
        self.pipe, self.cfg, self.stream = pipe, cfg, stream
        self.spin_every_imu = spin_every_imu
        self.decode_scan = decode_scan
        self.m = 0
        self.windows: list = []       # (t2, state, P, anchor, anchor_t) after each window
        self.step_s: List[float] = []
        self.feed_s = 0.0
        self.spin_s = 0.0

    def one(self) -> None:
        """Feed the next message, then spin as the feed rule says."""
        pipe = self.pipe
        kind, msg = self.stream.message(self.m)
        a = time.perf_counter()
        if kind == "imu":
            pipe.add_imu(*msg)
        else:
            xyz, rel, stamp, inten = msg
            pts, t, i = self.decode_scan(self.cfg, xyz, stamp, time_field=rel, intensity=inten)
            pipe.add_scan(pts, t, intensity=i)
        self.feed_s += time.perf_counter() - a
        self.m += 1
        if kind == "scan" or self.spin_every_imu:
            while True:
                a = time.perf_counter()
                got = pipe.spin_once()
                dt = time.perf_counter() - a
                self.spin_s += dt
                if not got:
                    break
                self.step_s.append(dt)
                self.windows.append((pipe.t2, pipe.x, pipe.P, pipe.anchor, pipe.anchor_t_dev))

    def until(self, m_end: int) -> None:
        while self.m < m_end:
            self.one()


class Tracer:
    """The traced run's readings.  `torch.profiler` with CUDA activity alone
    (kernels, copies, fills, and the runtime calls that launch and wait for
    them; no host operators, whose recording would stretch every window)
    over the first TRACE_WINDOWS windows of the measured window.  The
    grouped kernel's inputs are kept there, to count its work once the
    window has closed.  The host time of the windows after the trace is read
    from the program's stage timers and the harness's clock, untraced."""

    def __init__(self, loop: Loop):
        self.loop = loop
        self.active = False
        self.prof = None
        self.knn_calls: list = []
        self.windows = 0
        self.seconds = 0.0
        self.host_windows = 0
        self.host_s = 0.0
        self.host_stage_ms: Dict[str, float] = {}
        self.untraced_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        import limovelo_tpu_torch.ops.cuda.knn as knn_mod

        pipe = self.loop.pipe
        self._knn_mod, self._topk = knn_mod, knn_mod.group_topk

        def recorded(bucket_ids, order_q, centers, map_pts, k):
            self.knn_calls.append((bucket_ids, order_q, map_pts.shape[1], k))
            return self._topk(bucket_ids, order_q, centers, map_pts, k)

        knn_mod.group_topk = recorded
        self._step_window = pipe.step_window
        self.step_window_s = 0.0

        def step_window(t1, t2):
            a = time.perf_counter()
            r = self._step_window(t1, t2)
            self.step_window_s += time.perf_counter() - a
            return r

        pipe.step_window = step_window
        self._n0 = len(self.loop.windows)
        on_card = torch.cuda.is_available()
        if on_card:
            torch.cuda.synchronize()
        # (the CPU tests trace the host's operators: there is no device)
        self.prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def _marks(self):
        loop = self.loop
        stages = {k: v["total_ms"] for k, v in loop.pipe.timers.summary().items()}
        return (time.perf_counter(), len(loop.windows), loop.feed_s, loop.spin_s,
                self.step_window_s, stages)

    def maybe_stop(self) -> None:
        if self.active and len(self.loop.windows) - self._n0 >= TRACE_WINDOWS:
            self.stop()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.active = False
        self._knn_mod.group_topk = self._topk
        self.windows = len(self.loop.windows) - self._n0
        self._after = self._marks()

    def finish(self) -> None:
        """At the close of the measured window: the host time of the windows
        after the trace."""
        if self.active:
            self.stop()
        del self.loop.pipe.step_window
        t0, n0, feed0, spin0, sw0, st0 = self._after
        t1, n1, feed1, spin1, sw1, st1 = self._marks()
        self.host_windows = n1 - n0
        self.untraced_s = t1 - t0
        self.host_s = (feed1 - feed0) + (spin1 - spin0) - (sw1 - sw0)
        self.host_stage_ms = {k: st1[k] - st0.get(k, 0.0) for k in HOST_STAGES if k in st1}

    def events(self) -> List[tr.Ev]:
        ev = tr.events_from_profiler(self.prof)
        self.prof = None
        return ev


def _power_limit_w() -> Optional[float]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30, check=True)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _ate_m(records, cell: Cell) -> Optional[float]:
    """RMSE of the record positions against the course after the best rigid
    alignment (informational)."""
    from .traffic.stream import build

    if len(records) < 3:
        return None
    course = build(cell.config["course"])
    est = np.stack([r.p for r in records]).astype(np.float64)
    gt = course.position(np.array([r.t for r in records]))
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt)) or 1.0
    R = U @ S @ Vt
    err = np.linalg.norm((est - mu_e) @ R.T + mu_g - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_process0: float,
             device: str = "cuda") -> dict:
    """One run; returns the result object (the last line `run.py` prints),
    with the program's and the reference's outputs under "_outputs"."""
    from limovelo_tpu_torch import config as prog_config
    from limovelo_tpu_torch.io.pointcloud import decode_scan
    from limovelo_tpu_torch.native import get_lib
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    from .reference.replay import replay

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        from limovelo_tpu_torch.ops.cuda import build

        build.build(["knn_grouped"])
    get_lib()
    spin_every_imu = bool(cell.config["feed"]["spin_every_imu"])
    cfg = build_config(prog_config, cell.config, cell.mix)
    stream = make_stream(cell, seed, device)
    pipe = LioPipeline(cfg, device=device)
    loop = Loop(pipe, cfg, stream, spin_every_imu, decode_scan)
    loop.until(stream.ramp_messages)
    warm_windows = len(loop.windows)
    if on_card:
        torch.cuda.synchronize()
    # what set-up left behind is never collected again: the window's
    # collections walk only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process0

    # ---- the measured window ----
    tracer = Tracer(loop) if trace else None
    failed, error = 0, None
    n0 = len(loop.windows)
    if tracer:
        tracer.start()          # the profiler's own start-up is not part of the window
    t0 = time.perf_counter()
    try:
        while True:
            loop.one()
            if tracer:
                tracer.maybe_stop()
            if time.perf_counter() - t0 >= seconds:
                break
    except Exception as exc:   # a window that raised ends the window, and the run is wrong
        failed, error = 1, f"{type(exc).__name__}: {exc}"
    window_s = time.perf_counter() - t0
    if tracer:
        tracer.finish()
    gc.unfreeze()
    windows = len(loop.windows) - n0
    attempted = windows + failed
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    mem_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    step_s = loop.step_s[warm_windows:]

    prog = compare.collect(loop.windows, pipe.result.records)
    finite = compare.finite_windows(prog)
    failed += int((~finite[n0:]).sum())
    records = pipe.result.records
    measured_records = [r for r in records if r.t > (loop.windows[n0 - 1][0] if n0 else -1e300)]
    info = {
        "cell": cell.name, "seed": seed, "setup_windows": warm_windows, "windows": windows,
        "not_updated": windows - len(measured_records),
        "collapsed": int(pipe.collapsed_windows), "messages": loop.m,
        "points_per_scan": stream.points_per_scan(),
        "ds_points_p50": float(np.median([r.ds_count for r in measured_records]))
        if measured_records else None,
        "ate_m": _ate_m(records, cell), "error": error,
    }
    ctx = Context(setup_s=setup_s, windows=windows, window_s=window_s, step_s=step_s,
                  device_kind=kind)
    breakdown, busy_s, traced_s = None, 0.0, 0.0
    if tracer:
        events = tracer.events()
        ctx.events, ctx.traced_windows, ctx.traced_s = events, tracer.windows, tracer.seconds
        ctx.busy_s = busy_s = tr.busy_seconds(events)
        traced_s = tracer.seconds
        ctx.knn_calls = tracer.knn_calls
        ctx.host_windows, ctx.host_stage_ms = tracer.host_windows, tracer.host_stage_ms
        ctx.host_harness_s = tracer.host_s
        breakdown = {"device_ops": tr.top_device_ops(events),
                     "idle_gaps": tr.idle_by_host(events)}
        # what the profiler costs: a window's wall time traced and untraced
        info["traced_ms_per_window"] = 1e3 * tracer.seconds / max(tracer.windows, 1)
        info["untraced_ms_per_window"] = (1e3 * tracer.untraced_s / tracer.host_windows
                                          if tracer.host_windows else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    loop_windows = loop.windows
    del pipe, loop, tracer, ctx
    if on_card:
        torch.cuda.empty_cache()

    # ---- the check ----
    ref, _ = replay(cell, stream, info["messages"], device, follow=loop_windows)
    del loop_windows
    numbers = compare.gaps(prog, ref, bool(cfg.estimate_extrinsics))
    correct, checks = compare.judge(numbers, cell.limits, failed)
    correct = correct and attempted > 0
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": mem_peak,
                   "power_limit_w": _power_limit_w() if on_card else None}
    if trace:
        device_info.update(busy_s=busy_s, window_s=traced_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_info"] = info
    result["_outputs"] = (prog, ref)
    result["_stream"] = stream
    return result
