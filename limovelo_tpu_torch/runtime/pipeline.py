"""The orchestrator: drives the localize→map loop over accumulated sensors
(port of `limovelo_tpu/runtime/pipeline.py`).

Host code here does the time management (t1/t2 and the warm-up delta
schedule), index bookkeeping, padding and recording; the math runs in
`step.lio_step` and `step.mapping_step` on the pipeline's device.  Each
window's telemetry is read back right after its step (depth-1 resolution).
The rules that change results are the JAX package's:
- the host advances `last_time_updated` and its anchor-time bound
  optimistically when the raw window clears MAX_POINTS2MATCH;
- a window whose voxel downsample collapses below the threshold is consumed
  without retry (counted in `collapsed_windows`) and the bound rolls back to
  the device's anchor time;
- the IMU path window is selected from that bound, and the device masks it
  to samples strictly after its own anchor.

Mapping modes (`config.mapping_mode`): "online" inserts every accepted
window; "offline" re-deskews the last full rotation with the final states
once per `full_rotation_time` and inserts that; "none" never inserts (a
frozen map, `from_hd_map`).  With `map_prune_radius > 0` the map forgets
buckets beyond that radius of the pose every `map_prune_every` seconds.

A `publisher` (`runtime.publishers.Publisher`) receives each accepted
update's state, TF and extrinsics, and the window cloud, map stream, planes
and state history when a sink for them is attached; each of those is read
from the device only then.

With a `mesh` (parallel/sharding.py) every rank runs this pipeline on the
same feed and the step takes the rank's rows of each padded window:
`shard="points"` replicates the map, `shard="map"` partitions its table
rows over the ranks (parallel/map_sharding.py).  Every host decision reads
replicated values (the feed, the telemetry), so the ranks call their
collectives in one order.  Each accepted window's per-rank outputs (the
clouds, the medoid indices, the planes) are all-gathered at resolution on
every rank, whether or not a sink is attached here: which windows are
gathered is fixed when the mesh is given, so a publisher attached on rank 0
alone leaves no rank outside a collective.
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rsc

from ..config import DynParams
from ..device import resolve_device
from ..filter.process import ImuWindow, process_noise_Q
from ..geometry import state as st
from ..mapping.hashgrid import GridParams, HashGridMap, make_map, prune
from ..step import (TEL_ANCHOR_T, TEL_DELTA_NORM, TEL_DS_COUNT, TEL_EIG, TEL_EXT_R,
                    TEL_EXT_T, TEL_ITERS, TEL_MAP_BUCKETS, TEL_MAP_DROPPED,
                    TEL_MAP_POINTS, TEL_MATCHES, TEL_P, TEL_R, TEL_RESIDUAL,
                    TEL_UPDATED, TEL_V, StepInputs, lio_step, mapping_step)
from .accumulator import Accumulator
from .profiling import StageTimers

_NOT_PORTED = "not ported yet (ROADMAP.md, 'Port: what is left', item {})"


@dataclass
class StepRecord:
    """Per-update metrics (one per accepted window)."""

    t: float
    R: np.ndarray
    p: np.ndarray
    v: np.ndarray
    updated: bool
    ds_count: int
    num_matches: int
    mean_residual: float
    iterations: int
    wall_ms: float
    eigenvalues: np.ndarray = field(default_factory=lambda: np.zeros(12))
    extr_rotvec: np.ndarray = field(default_factory=lambda: np.zeros(3))
    extr_t: np.ndarray = field(default_factory=lambda: np.zeros(3))
    map_points: int = 0
    map_buckets: int = 0
    map_dropped: int = 0
    delta_norm: float = 0.0


@dataclass
class OdometryResult:
    records: List[StepRecord] = field(default_factory=list)

    @property
    def times(self):
        return np.array([r.t for r in self.records])

    @property
    def positions(self):
        return np.stack([r.p for r in self.records]) if self.records else np.zeros((0, 3))

    @property
    def rotations(self):
        return np.stack([r.R for r in self.records]) if self.records else np.zeros((0, 3, 3))


class AnchorRec(NamedTuple):
    """One entry of the corrected-state history: the state at an accepted
    update and the controls that seed a re-deskew path from it.  `R_h`/`p_h`
    are host copies of the pose (from the telemetry), so publishing the state
    history reads nothing from the device; the dispatch-time history, which
    no telemetry has reached yet, leaves them None."""

    t: float
    x: object          # NavState on the device
    a: np.ndarray
    w: np.ndarray
    R_h: Optional[np.ndarray] = None
    p_h: Optional[np.ndarray] = None


class LioPipeline:
    """Feed sensors in (any interleaving), call `spin()`, read the trajectory
    out of `result`.  Runs on `device` ("cuda" by default; raises when no
    card is present — pass device="cpu" to run the plain versions), or on
    the mesh's device with a `mesh` (every rank builds the pipeline with the
    same arguments)."""

    def __init__(self, config, device="cuda", grid: Optional[GridParams] = None,
                 publisher=None, mesh=None, shard: str = "points"):
        self.config = config
        self.publisher = publisher
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.grid = grid or GridParams.from_config(config)
        self.mesh = mesh
        self.shard = shard
        self._sharded_step = None
        if mesh is not None:
            if config.mapping_mode == "offline":
                raise ValueError("mesh mode supports mapping 'online' or 'none'; the offline "
                                 "re-deskew mapping step is single-device")
            if shard == "map":
                from ..parallel.map_sharding import make_map_sharded_step

                self._sharded_step = make_map_sharded_step(mesh, config, self.grid)
            elif shard == "points":
                from ..parallel.sharding import make_sharded_step

                self._sharded_step = make_sharded_step(mesh, config, self.grid)
            else:
                raise ValueError(f"shard must be 'points' or 'map', got {shard!r}")
        self.accum = Accumulator(config)
        self._result = OdometryResult()

        self._initialized = False
        self._preloaded_map = None
        self.map = None
        self.x = None
        self.P = None
        self.Q = process_noise_Q(config, device=self.device)
        self.dyn = DynParams.from_config(config)
        self._static = config.static()
        # host times are absolute float64; the device sees them rebased
        self.t2: Optional[float] = None
        self.last_time_updated: Optional[float] = None
        self.last_time_integrated: Optional[float] = None
        # the anchor itself lives on the device (threaded through the steps);
        # `anchor_t` is the host's lower bound of its time, which selects the
        # IMU path window
        self.anchor = None
        self.anchor_t: Optional[float] = None
        self.anchor_t_dev = None
        self.last_map_time: Optional[float] = None
        # two corrected-state histories, kept apart as in the JAX package
        # (they differ on collapsed windows): `_anchors_d` is appended at
        # dispatch whenever the raw count clears the threshold and feeds the
        # offline re-deskew; `_anchors` is appended at resolution when the
        # window updated, and is checkpointed
        self._anchors: List[AnchorRec] = []
        self._anchors_d: List[AnchorRec] = []
        self._last_prune_t: Optional[float] = None
        # the latest accepted window on the device (full resolution and
        # downsampled, with the medoids' window indices) and its intensity
        # on the host; read back only by the properties below
        self._last_gpts_dev = None
        self._last_gds_dev = None
        self._last_gds_idx_dev = None
        self._last_win_int: Optional[np.ndarray] = None
        self.stream_dead = False
        self._last_processed_t2: float = -np.inf
        # windows whose raw count cleared MAX_POINTS2MATCH but whose voxel
        # downsample fell below it: consumed without retry
        self.collapsed_windows = 0
        self.timers = StageTimers()

    @classmethod
    def from_hd_map(cls, config, map_path: str, device="cuda",
                    grid: Optional[GridParams] = None, publisher=None, mesh=None,
                    shard: str = "points") -> "LioPipeline":
        """Localize against a prebuilt HD map (saved by `checkpoint.save_map`
        of either package).  Unless the config sets `mapping`, the map is
        frozen (mode "none"): nothing is inserted and the map stays
        bit-identical for the whole run.  With a mesh the map is replicated
        (`shard="points"`); map sharding refuses a preloaded map when the
        run starts, as the JAX package does."""
        from .checkpoint import load_map

        if config.mapping is None:
            config = config.replace(mapping="none")
        pipe = cls(config, device=device, grid=grid, publisher=publisher, mesh=mesh, shard=shard)
        pipe._preloaded_map = load_map(map_path, pipe.grid, device=pipe.device)
        return pipe

    @property
    def result(self) -> OdometryResult:
        return self._result

    # ------------------------------------------------------------------
    def add_scan(self, pts, t, intensity=None):
        self.accum.add_scan(pts, t, intensity=intensity)

    def add_imu(self, t, a, w, q=None):
        self.accum.add_imu(t, a, w, q)

    # ------------------------------------------------------------------
    def _initialize(self):
        """Deferred initialization once enough IMUs are buffered."""
        dev = self.device
        imu0 = self.accum.initial_imu()
        R0 = None if imu0.q is None else Rsc.from_quat(imu0.q).as_matrix()
        self.x = st.make_initial(self.config, R0=R0, device=dev)
        self.P = st.initial_covariance(self.config, device=dev)
        self.map = self._preloaded_map
        map_sharded = self.mesh is not None and self.shard == "map"
        if self.map is None:
            if map_sharded:
                from ..parallel.map_sharding import make_sharded_map

                self.map = make_sharded_map(self.mesh, self.grid)
            else:
                self.map = make_map(self.grid, device=dev)
        elif map_sharded:
            raise ValueError("HD-map prelocalization is not supported with map-block "
                             "sharding; use shard='points'")
        t0 = self.accum.initial_time
        self.t2 = t0
        self.last_time_updated = t0
        self.last_time_integrated = t0
        self.anchor = self.x
        self.anchor_t = t0
        self.anchor_t_dev = torch.zeros((), dtype=torch.float32, device=dev)
        self._initialized = True

    def _pad_imus_np(self, ts, accs, gyrs, t2, rebase):
        """Padded numpy IMU arrays covering (·, t2], with the final entry
        that extrapolates the last sample to t2."""
        cfg = self.config
        m = len(ts)
        entries_t = list(ts - rebase)
        entries_a = list(accs)
        entries_w = list(gyrs)
        if m > 0 and ts[-1] < t2:
            entries_t.append(t2 - rebase)
            entries_a.append(accs[-1])
            entries_w.append(gyrs[-1])
        M = len(entries_t)
        bucket = cfg.bucket_for(max(M, 1), cfg.imu_buckets)
        t_arr = np.zeros(bucket, np.float32)
        a_arr = np.zeros((bucket, 3), np.float32)
        w_arr = np.zeros((bucket, 3), np.float32)
        mask = np.zeros(bucket, bool)
        if M:
            t_arr[:M] = entries_t
            a_arr[:M] = entries_a
            w_arr[:M] = entries_w
            mask[:M] = True
        return t_arr, a_arr, w_arr, mask

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _pad_points(self, t1: float, t2: float, rebase: float):
        """Points with t in (t1, t2], padded to their shape bucket (the
        newest kept when the window overfills it): (pts, rebased t, mask,
        intensity, n)."""
        cfg = self.config
        pts, pts_t, pts_i = self.accum.get_points(t1, t2)
        n = len(pts)
        bucket = cfg.bucket_for(max(n, 1), cfg.point_buckets)
        if n > bucket:
            pts, pts_t, pts_i = pts[-bucket:], pts_t[-bucket:], pts_i[-bucket:]
            n = bucket
        pts_pad = np.zeros((bucket, 3), np.float32)
        t_pad = np.zeros(bucket, np.float32)
        mask = np.zeros(bucket, bool)
        int_pad = np.zeros(bucket, np.float32)
        pts_pad[:n] = pts
        t_pad[:n] = (pts_t - rebase).astype(np.float32)
        mask[:n] = True
        int_pad[:n] = pts_i
        return pts_pad, t_pad, mask, int_pad, n

    # ------------------------------------------------------------------
    def step_window(self, t1: float, t2: float) -> Optional[StepRecord]:
        """Run one localization window (t1, t2] and resolve its telemetry;
        returns the record when the window updated."""
        cfg = self.config
        wall0 = _time.perf_counter()
        rebase = self.accum.initial_time

        with self.timers("assemble"):
            pts_pad, t_pad, mask, win_int, n = self._pad_points(t1, t2, rebase)
            imu_f = self._pad_imus_np(*self.accum.get_imus(self.last_time_integrated, t2),
                                      t2, rebase)
            # path window: a superset from the host's anchor-time bound
            imu_p = self._pad_imus_np(*self.accum.get_imus(self.anchor_t, t2), t2, rebase)
            nxt = self.accum.get_next_imu(self.anchor_t)
            anchor_a = nxt.a if nxt is not None else np.zeros(3, np.float32)
            anchor_w = nxt.w if nxt is not None else np.zeros(3, np.float32)

        if self.mesh is not None:
            # the rank's contiguous block of the padded window's rows
            from ..parallel.sharding import shard_rows

            rows = shard_rows(self.mesh, len(pts_pad))
            pts_pad, t_pad, mask = pts_pad[rows], t_pad[rows], mask[rows]
        with self.timers("h2d"):
            f32 = np.float32
            inp = StepInputs(
                anchor=self.anchor,
                anchor_t=self.anchor_t_dev,
                anchor_a=self._to_dev(np.asarray(anchor_a, f32)),
                anchor_w=self._to_dev(np.asarray(anchor_w, f32)),
                x=self.x,
                P=self.P,
                t_integrated=self._to_dev(f32(self.last_time_integrated - rebase)),
                imus_filter=ImuWindow(*(self._to_dev(v) for v in imu_f)),
                imus_path=ImuWindow(*(self._to_dev(v) for v in imu_p)),
                pts=self._to_dev(pts_pad),
                pts_t=self._to_dev(t_pad),
                pts_mask=self._to_dev(mask),
                t2=self._to_dev(f32(t2 - rebase)),
                Q=self.Q,
                dyn=self.dyn,
            )
        with self.timers("step"):
            if self._sharded_step is not None:
                out = self._sharded_step(inp, self.map)
            else:
                out = lio_step(inp, self.map, self._static, self.grid)

        self.map = out.map
        self.x = out.x
        self.P = out.P
        self.anchor = out.anchor
        self.anchor_t_dev = out.anchor_t
        self.last_time_integrated = t2
        # optimistic advance: the next window's t1 must not re-include this
        # window's points, and the anchor bound follows the raw count
        advanced = n >= cfg.MAX_POINTS2MATCH
        if advanced:
            self.last_time_updated = t2
            self.anchor_t = max(self.anchor_t, t2)
            if self.last_map_time is None:
                # the offline cadence starts at the first advance
                self.last_map_time = t2
            # dispatch-time history (device refs): controls = first IMU at
            # or after t2
            nxt2 = self.accum.get_next_imu(t2)
            self._anchors_d.append(AnchorRec(
                t2, out.x,
                nxt2.a if nxt2 is not None else anchor_a,
                nxt2.w if nxt2 is not None else anchor_w,
            ))
            horizon = t2 - 2 * max(cfg.full_rotation_time, 0.2)
            self._anchors_d = ([a for a in self._anchors_d if a.t >= horizon]
                               or self._anchors_d[-1:])

        # offline mode: map every full rotation with the final states
        if (cfg.mapping_mode == "offline" and self.last_map_time is not None
                and t2 - self.last_map_time >= cfg.full_rotation_time and self._anchors_d):
            with self.timers("offline_map"):
                self._offline_map(t2, rebase)
            self.last_map_time = t2

        # GC: time-based, needs no device values
        self.accum.clear_lidar(t2 - cfg.empty_lidar_time)
        self.accum.clear_imus(min(self.anchor_t, self.last_time_integrated) - 1.0)

        with self.timers("tele_read"):
            tele = out.telemetry.cpu().numpy()
        with self.timers("resolve_host"):
            return self._resolve(t2, rebase, advanced, tele, wall0, out, anchor_a, anchor_w,
                                 win_int)

    def _resolve(self, t2, rebase, advanced, tele, wall0, out, anchor_a, anchor_w, win_int
                 ) -> Optional[StepRecord]:
        """Host bookkeeping of a finished step from its telemetry."""
        cfg = self.config
        updated = bool(tele[TEL_UPDATED] > 0.5)
        dev_anchor_t = float(tele[TEL_ANCHOR_T])
        if advanced and not updated:
            # the optimistic bound was wrong for this window: roll back to
            # the device's anchor time
            self.collapsed_windows += 1
            if dev_anchor_t >= 0.0:
                self.anchor_t = rebase + dev_anchor_t
        elif dev_anchor_t >= 0.0:
            self.anchor_t = max(self.anchor_t, rebase + dev_anchor_t)
        if not updated:
            return None
        R_h, p_h = np.asarray(tele[TEL_R]).reshape(3, 3), np.asarray(tele[TEL_P])
        self.last_time_updated = max(self.last_time_updated, t2)
        nxt = self.accum.get_next_imu(t2)
        self._anchors.append(AnchorRec(
            t2, out.x,
            nxt.a if nxt is not None else anchor_a,
            nxt.w if nxt is not None else anchor_w,
            R_h, p_h,
        ))
        horizon = t2 - 2 * max(cfg.full_rotation_time, 0.2)
        self._anchors = [a for a in self._anchors if a.t >= horizon] or self._anchors[-1:]
        if self.last_map_time is None:
            self.last_map_time = t2

        # map lifecycle: forget buckets beyond map_prune_radius of the pose
        if cfg.map_prune_radius > 0:
            if self._last_prune_t is None:
                self._last_prune_t = t2
            elif t2 - self._last_prune_t >= cfg.map_prune_every:
                center = self._to_dev(p_h.astype(np.float32))
                with self.timers("prune"):
                    if self.mesh is not None and self.shard == "map":
                        from ..parallel.map_sharding import local_grid, prune_sharded

                        self.map = prune_sharded(self.map, center, cfg.map_prune_radius,
                                                 local_grid(self.grid, self.mesh.size), self.mesh)
                    else:
                        self.map = prune(self.map, center, cfg.map_prune_radius, self.grid)
                self._last_prune_t = t2

        rec = StepRecord(
            t=t2,
            R=R_h,
            p=p_h,
            v=np.asarray(tele[TEL_V]),
            updated=updated,
            ds_count=int(tele[TEL_DS_COUNT]),
            num_matches=int(tele[TEL_MATCHES]),
            mean_residual=float(tele[TEL_RESIDUAL]),
            iterations=int(tele[TEL_ITERS]),
            wall_ms=(_time.perf_counter() - wall0) * 1e3,
            eigenvalues=np.asarray(tele[TEL_EIG]),
            extr_rotvec=np.asarray(tele[TEL_EXT_R]),
            extr_t=np.asarray(tele[TEL_EXT_T]),
            map_points=int(tele[TEL_MAP_POINTS]),
            map_buckets=int(tele[TEL_MAP_BUCKETS]),
            map_dropped=int(tele[TEL_MAP_DROPPED]),
            delta_norm=float(tele[TEL_DELTA_NORM]),
        )
        self._result.records.append(rec)
        if self.mesh is not None:
            with self.timers("gather"):
                out = self._gather_window(out)
        self._last_gpts_dev = (out.global_pts, out.global_mask)
        self._last_gds_dev = (out.global_ds, out.global_ds_mask)
        self._last_gds_idx_dev = out.global_ds_idx
        self._last_win_int = win_int
        if self.publisher is not None:
            self._publish(rec, out)
        self._on_record(rec)
        return rec

    def _publish(self, rec: StepRecord, out) -> None:
        """Hand one accepted update to the publisher (main.cpp:87-105): state
        and TF, extrinsics, the window cloud (the downsampled localization
        cloud, /limovelo/pcl), the online map stream (/limovelo/full_pcl:
        full resolution when `high_quality_publish`), the chosen matches'
        planes and the state history.  A cloud, the planes and the history
        are read only when a sink for them is attached."""
        cfg, pub = self.config, self.publisher
        pub.state(rec)
        if cfg.print_extrinsics:
            pub.extrinsics(rec)
        if getattr(pub, "on_cloud", None):
            g, inten = self._last_gds_i
            pub.cloud(g, rec.t, intensity=inten)
        if cfg.mapping_mode == "online" and getattr(pub, "on_full_cloud", None):
            g, inten = self._last_gpts_i if cfg.high_quality_publish else self._last_gds_i
            pub.full_cloud(g, rec.t, intensity=inten)
        if getattr(pub, "wants_planes", False):
            d = out.diag
            cen, nrm, pv = (v.cpu().numpy() for v in
                            (d.plane_centroids, d.plane_normals, d.plane_valid))
            pub.planes(cen[pv], nrm[pv], rec.t)
        if getattr(pub, "on_states", None):
            ts = np.array([a.t for a in self._anchors])
            pub.states(ts, np.stack([a.p_h for a in self._anchors]),
                       np.stack([a.R_h for a in self._anchors]), rec.t)

    def _gather_window(self, out):
        """The whole window's outputs from the ranks' rows (one
        all-gather): the clouds, their masks, the medoids' window indices
        and the planes."""
        from ..parallel.sharding import gather_rows

        d = out.diag
        g, gm, gd, gdm, gdi, nrm, cen, pv = gather_rows(self.mesh, [
            out.global_pts, out.global_mask, out.global_ds, out.global_ds_mask,
            out.global_ds_idx, d.plane_normals, d.plane_centroids, d.plane_valid])
        return out._replace(global_pts=g, global_mask=gm, global_ds=gd, global_ds_mask=gdm,
                            global_ds_idx=gdi,
                            diag=d._replace(plane_normals=nrm, plane_centroids=cen,
                                            plane_valid=pv))

    def full_map(self) -> HashGridMap:
        """The whole map: `self.map`, or with a map-sharded mesh the ranks'
        shards joined in the JAX package's layout (table rows in rank order,
        counters of shape (D,)).  A collective then: every rank calls it."""
        if self.mesh is not None and self.shard == "map":
            from ..parallel.map_sharding import gather_map

            return gather_map(self.map, self.mesh)
        return self.map

    def _on_record(self, rec: StepRecord) -> None:
        """Hook: called once per accepted update, after publishing, while
        `self.x` and `_last_gpts_dev` still belong to that step (the SLAM
        layer keyframes here)."""

    @property
    def _last_gpts(self) -> Optional[np.ndarray]:
        """The latest accepted window, deskewed, in the world frame at full
        resolution (host copy)."""
        if self._last_gpts_dev is None:
            return None
        g, msk = self._last_gpts_dev
        return g[msk].cpu().numpy()

    @property
    def _last_gds(self) -> Optional[np.ndarray]:
        """The latest accepted window, downsampled, in the world frame (host
        copy)."""
        if self._last_gds_dev is None:
            return None
        g, msk = self._last_gds_dev
        return g[msk].cpu().numpy()

    @property
    def _last_gpts_i(self):
        """(full-resolution window, per-point intensity): the full cloud
        keeps the window's order, so the intensity aligns by the mask."""
        if self._last_gpts_dev is None:
            return None, None
        g, msk = (v.cpu().numpy() for v in self._last_gpts_dev)
        return g[msk], self._last_win_int[msk]

    @property
    def _last_gds_i(self):
        """(downsampled window, per-point intensity): the intensity is
        gathered through the medoids' window indices (ops/voxel
        `Downsampled.idx`)."""
        if self._last_gds_dev is None:
            return None, None
        g, msk, idx = (v.cpu().numpy() for v in (*self._last_gds_dev, self._last_gds_idx_dev))
        return g[msk], self._last_win_int[idx[msk]]

    def _offline_map(self, t2: float, rebase: float) -> None:
        """Re-deskew (t2 − full_rotation_time, t2] from the oldest kept
        dispatch-time anchor at or before its start (else the oldest kept)
        with the final state, insert the downsampled global cloud, and
        publish it as the map stream (main.cpp:107-117: at full resolution
        when `high_quality_publish`) when a sink is attached."""
        cfg = self.config
        t_lo = t2 - cfg.full_rotation_time
        pts_pad, t_pad, mask, int_pad, n = self._pad_points(t_lo, t2, rebase)
        if n == 0:
            return
        older = [a for a in self._anchors_d if a.t <= t_lo]
        a_t, a_x, a_a, a_w = (older[-1] if older else self._anchors_d[0])[:4]
        imus = self._pad_imus_np(*self.accum.get_imus(a_t, t2), t2, rebase)
        f32 = np.float32
        self.map, g_full, g_mask, g_ds, ds_mask, ds_idx = mapping_step(
            self.map, a_x, self._to_dev(f32(a_t - rebase)), self._to_dev(np.asarray(a_a, f32)),
            self._to_dev(np.asarray(a_w, f32)), ImuWindow(*(self._to_dev(v) for v in imus)),
            self.x, self._to_dev(f32(t2 - rebase)), self._to_dev(pts_pad), self._to_dev(t_pad),
            self._to_dev(mask), self.dyn, self.grid)
        if self.publisher is not None and getattr(self.publisher, "on_full_cloud", None):
            if cfg.high_quality_publish:
                g, msk = (v.cpu().numpy() for v in (g_full, g_mask))
                inten = int_pad[msk]
            else:
                g, msk, idx = (v.cpu().numpy() for v in (g_ds, ds_mask, ds_idx))
                inten = int_pad[idx[msk]]
            self.publisher.full_cloud(g[msk], t2, intensity=inten)

    def flush(self) -> None:
        """Nothing is in flight: every step resolves when it runs."""

    # ------------------------------------------------------------------
    def spin_once(self) -> bool:
        """One main-loop pass; returns True if a window was processed."""
        cfg = self.config
        if not self.accum.ready():
            return False
        # stream-death detector: stop instead of spinning on a dead feed
        if self.accum.ended(self.accum.newest_data_time()):
            if not self.stream_dead:
                self.stream_dead = True
                logging.getLogger(__name__).error(
                    "Sensor stream appears dead (<2 IMUs in the last 3 s); "
                    "stopping the localization loop.")
            return False
        self.stream_dead = False
        if not self._initialized:
            self._initialize()

        latest = self.accum.latest_time()
        if cfg.real_time:
            t2 = latest
        else:
            delta_prev = self.accum.update_delta(self.t2)
            t2 = min(self.t2 + delta_prev, latest)
        delta = self.accum.update_delta(t2)
        t1 = max(t2 - delta, self.last_time_updated)
        # t2 advances even when the window is skipped
        self.t2 = t2
        if t2 - t1 < delta - 1e-6:
            return False
        # never reprocess an already-attempted window
        if t2 <= self._last_processed_t2 + 1e-9:
            return False
        self._last_processed_t2 = t2
        self.step_window(t1, t2)
        return True

    def spin(self, max_steps: int = 10 ** 9) -> int:
        steps = 0
        while steps < max_steps and self.spin_once():
            steps += 1
        return steps
