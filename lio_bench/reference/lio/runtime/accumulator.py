"""Host-side sensor accumulation and window bookkeeping (a copy of
`limovelo_tpu/runtime/accumulator.py`, which the port must not import).

Analog of the reference `Accumulator` + `Buffer<T>`
(the reference's `src/Modules/Accumulator.cpp`, `src/Objects/Buffer.cpp`):
time-indexed stores with range queries, readiness logic, the warm-up delta
schedule, and garbage collection.  Differences by design (SURVEY.md §7):

- Storage is flat numpy arrays (sorted ascending by time), not newest-first
  deques of objects; range queries are `np.searchsorted` over the sort key.
- All device-facing times are rebased to `initial_time` and cast to float32
  (absolute epoch stamps would destroy f32 precision on the device).
- The missing-per-point-time fallback (Accumulator.cpp:178-201) is explicit
  state here instead of a runtime mutation of the global config.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ImuRecord:
    t: float
    a: np.ndarray
    w: np.ndarray
    q: Optional[np.ndarray] = None  # orientation quaternion (x,y,z,w) if known


class Accumulator:
    def __init__(self, config):
        self.config = config
        # point store (ascending time)
        self._pts: List[np.ndarray] = []
        self._pts_t: List[np.ndarray] = []
        self._pts_i: List[np.ndarray] = []   # per-point intensity channel
        # imu store
        self._imu_t: List[float] = []
        self._imu_a: List[np.ndarray] = []
        self._imu_w: List[np.ndarray] = []
        self._imu_q: List[Optional[np.ndarray]] = []
        self.initial_time: Optional[float] = None
        self._ready = False
        self.missing_point_times = False
        self._warned_missing = False

    # ------------------------------------------------------------------
    # ingest (receive_lidar / receive_imu)
    # ------------------------------------------------------------------
    def add_scan(self, pts: np.ndarray, t: np.ndarray, intensity=None):
        """Add a time-sorted scan (LiDAR frame, absolute stamps).

        Vendor decoding / temporal downsample / min-range filtering happen in
        the caller before this (the JAX package's io.pointcloud).  `intensity`
        (N,) rides along per point (reference Point carries it end to end,
        Objects.hpp:20-27); zeros if the sensor gives none."""
        if len(pts) == 0:
            return
        # missing-timestamp fallback: all-zero times → fixed delta schedule
        if len(pts) >= self.config.MAX_POINTS2MATCH and t[0] == 0 and t[-1] == 0:
            self.missing_point_times = True
            if not self._warned_missing:
                self._warned_missing = True
                import logging

                logging.getLogger(__name__).error(
                    "LiDAR points are missing 'time' information. Delta fixed "
                    "to %f s (%d Hz localization).",
                    self.config.full_rotation_time,
                    int(1.0 / self.config.full_rotation_time),
                )
        order = np.argsort(t, kind="stable")
        self._pts.append(np.asarray(pts, np.float32)[order])
        self._pts_t.append(np.asarray(t, np.float64)[order])
        inten = (np.zeros(len(pts), np.float32) if intensity is None
                 else np.asarray(intensity, np.float32))
        self._pts_i.append(inten[order])

    def add_imu(self, t: float, a, w, q=None):
        t = float(t)
        a = np.asarray(a, np.float32)
        w = np.asarray(w, np.float32)
        q = None if q is None else np.asarray(q, np.float64)
        if self._imu_t and t < self._imu_t[-1]:
            # late (reordered) packet: insert in time order so the
            # searchsorted range queries stay correct — transport-level
            # reordering must not corrupt the window math (SURVEY.md §5
            # fault-injection plan; the reference would silently corrupt its
            # descending-time binary searches here)
            import bisect

            i = bisect.bisect_right(self._imu_t, t)
            self._imu_t.insert(i, t)
            self._imu_a.insert(i, a)
            self._imu_w.insert(i, w)
            self._imu_q.insert(i, q)
            return
        self._imu_t.append(t)
        self._imu_a.append(a)
        self._imu_w.append(w)
        self._imu_q.append(q)

    # ------------------------------------------------------------------
    # readiness (Accumulator::ready / enough_imus / set_initial_time)
    # ------------------------------------------------------------------
    def ready(self) -> bool:
        if self._ready:
            return True
        need = 2 * self.config.real_time_delay * self.config.imu_rate + 10
        if len(self._imu_t) > need:
            self.initial_time = self._imu_t[-1] - self.config.real_time_delay
            self._ready = True
        return self._ready

    def initial_imu(self) -> ImuRecord:
        """Last IMU at/before initial_time (Localizator::initialize seed)."""
        ts = np.asarray(self._imu_t)
        i = int(np.searchsorted(ts, self.initial_time, side="right")) - 1
        i = max(i, 0)
        return ImuRecord(ts[i], self._imu_a[i], self._imu_w[i], self._imu_q[i])

    def latest_time(self) -> float:
        """Newest IMU stamp − real_time_delay (Accumulator.cpp:129-135)."""
        return self._imu_t[-1] - self.config.real_time_delay

    def ended(self, t: float) -> bool:
        """Stream-death detector (Accumulator.cpp:117-122)."""
        if not self.ready() or t - self.initial_time < 3:
            return False
        ts = np.asarray(self._imu_t)
        lo = np.searchsorted(ts, t - 3.0, side="right")
        hi = np.searchsorted(ts, t, side="right")
        return (hi - lo) < 2

    def newest_data_time(self) -> float:
        """Newest stamp across both streams — the 'now' the stream-death
        detector is evaluated against (points keep arriving after the IMU
        dies, so IMU-only time would never notice)."""
        t = self._imu_t[-1] if self._imu_t else -np.inf
        if self._pts_t and len(self._pts_t[-1]):
            t = max(t, float(self._pts_t[-1][-1]))
        return t

    def update_delta(self, t: float) -> float:
        if self.missing_point_times:
            return self.config.full_rotation_time
        return self.config.Initialization.delta_at(t - self.initial_time)

    # ------------------------------------------------------------------
    # range queries
    # ------------------------------------------------------------------
    def get_points(self, t1: float, t2: float):
        """Points with t ∈ (t1, t2] → (pts (N,3), t (N,), intensity (N,))."""
        ps, ts, iis = [], [], []
        for p, t, ii in zip(self._pts, self._pts_t, self._pts_i):
            if len(t) == 0 or t[-1] <= t1 or t[0] > t2:
                continue
            lo = np.searchsorted(t, t1, side="right")
            hi = np.searchsorted(t, t2, side="right")
            ps.append(p[lo:hi])
            ts.append(t[lo:hi])
            iis.append(ii[lo:hi])
        if not ps:
            return (np.zeros((0, 3), np.float32), np.zeros((0,), np.float64),
                    np.zeros((0,), np.float32))
        pts = np.concatenate(ps)
        tts = np.concatenate(ts)
        inten = np.concatenate(iis)
        order = np.argsort(tts, kind="stable")
        return pts[order], tts[order], inten[order]

    def get_imus(self, t1: float, t2: float):
        """IMU samples with t ∈ (t1, t2] → (t (M,), a (M,3), w (M,3))."""
        ts = np.asarray(self._imu_t)
        lo = np.searchsorted(ts, t1, side="right")
        hi = np.searchsorted(ts, t2, side="right")
        if hi <= lo:
            return (np.zeros(0), np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
        return (
            ts[lo:hi].copy(),
            np.stack(self._imu_a[lo:hi]),
            np.stack(self._imu_w[lo:hi]),
        )

    def get_prev_imu(self, t: float) -> Optional[ImuRecord]:
        ts = np.asarray(self._imu_t)
        i = int(np.searchsorted(ts, t, side="right")) - 1
        if i < 0:
            return None
        return ImuRecord(ts[i], self._imu_a[i], self._imu_w[i], self._imu_q[i])

    def get_next_imu(self, t: float) -> Optional[ImuRecord]:
        """First IMU at/after t (State ctor control seed, State.cpp:46)."""
        ts = np.asarray(self._imu_t)
        i = int(np.searchsorted(ts, t, side="left"))
        if i >= len(ts):
            return self.get_prev_imu(t)
        return ImuRecord(ts[i], self._imu_a[i], self._imu_w[i], self._imu_q[i])

    # ------------------------------------------------------------------
    # GC (clear_lidar / Buffer::clear)
    # ------------------------------------------------------------------
    def clear_lidar(self, t: float):
        keep_p, keep_t, keep_i = [], [], []
        for p, tt, ii in zip(self._pts, self._pts_t, self._pts_i):
            if len(tt) and tt[-1] >= t:
                lo = np.searchsorted(tt, t, side="left")
                keep_p.append(p[lo:])
                keep_t.append(tt[lo:])
                keep_i.append(ii[lo:])
        self._pts, self._pts_t, self._pts_i = keep_p, keep_t, keep_i

    def clear_imus(self, t: float):
        ts = np.asarray(self._imu_t)
        lo = int(np.searchsorted(ts, t, side="left"))
        if lo > 0:
            self._imu_t = self._imu_t[lo:]
            self._imu_a = self._imu_a[lo:]
            self._imu_w = self._imu_w[lo:]
            self._imu_q = self._imu_q[lo:]
