"""SLAM layer: LIO pipeline + keyframes + loop closure + pose-graph backend
(port of `limovelo_tpu/runtime/slam.py`, single device).

`SlamPipeline` wraps `LioPipeline`:

- every accepted update is offered to the keyframe selector (the scan is
  stored in the LiDAR frame at its own pose);
- every `loop_check_every` keyframes, loop candidates are detected by
  trajectory proximity and verified and measured by point-to-plane
  registration of the two keyframes' scans (graph/loop_closure.py);
- `optimized_trajectory()` optimizes the pose graph (odometry chain + loop
  edges) and returns the corrected keyframe trajectory.

The live filter state is not rewritten on a closure: loop closures correct
the trajectory product, not the real-time estimator.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

from ..graph import (KeyframeSelector, KeyframeStore, PoseGraph, detect_loop_candidates,
                     optimize_pose_graph, register_scan_to_map)
from .pipeline import LioPipeline


class SlamPipeline(LioPipeline):
    def __init__(
        self,
        config,
        device="cuda",
        grid=None,
        kf_min_translation: float = 2.0,
        kf_min_rotation_deg: float = 15.0,
        loop_check_every: int = 5,
        loop_min_index_gap: int = 20,
        loop_max_distance: float = 5.0,
        loop_max_rms: float = 0.15,
    ):
        super().__init__(config, device=device, grid=grid)
        self.keyframes = KeyframeStore(KeyframeSelector(kf_min_translation, kf_min_rotation_deg))
        self.loop_edges: List[Tuple[int, int]] = []
        # every registration attempt, accepted or not
        self.loop_stats: List[dict] = []
        self._graph_loops: List[tuple] = []
        self._loop_check_every = loop_check_every
        self._loop_min_index_gap = loop_min_index_gap
        self._loop_max_distance = loop_max_distance
        self._loop_max_rms = loop_max_rms
        self._closed_pairs = set()
        self.consensus_rejected = 0

    # ------------------------------------------------------------------
    def _on_record(self, rec):
        # the pose gate runs on the record's host floats before the scan is
        # copied off the device; the selector advances its reference pose
        # only when the keyframe is stored
        if self._last_gpts_dev is None or not self.keyframes.selector.should_add(rec.R, rec.p):
            return
        g = self._last_gpts
        R_LI = Rsc.from_rotvec(rec.extr_rotvec).as_matrix()
        R_wl = rec.R @ R_LI
        t_wl = rec.p + rec.R @ rec.extr_t
        scan_lidar = (g - t_wl) @ R_wl
        self.keyframes.add(rec.t, rec.R, rec.p, scan_lidar.astype(np.float32))
        if len(self.keyframes) % self._loop_check_every == 0:
            self._check_loops()

    # ------------------------------------------------------------------
    def _check_loops(self):
        frames = self.keyframes.frames
        ps = self.keyframes.positions(optimized=False)
        for i, j in detect_loop_candidates(ps, self._loop_min_index_gap, self._loop_max_distance):
            if (i, j) in self._closed_pairs:
                continue
            self._closed_pairs.add((i, j))
            fi, fj = frames[i], frames[j]
            # register scan_i against scan_j in fj's frame, from the
            # odometry's relative pose
            R0 = fj.R.T @ fi.R
            p0 = fj.R.T @ (fi.p - fj.p)
            R, p, rms, n = register_scan_to_map(fi.scan, fj.scan, R0.astype(np.float32),
                                                p0.astype(np.float32), device=self.device)
            accepted = rms < self._loop_max_rms and n > 200
            self.loop_stats.append({"t": fi.t, "i": i, "j": j, "rms": rms, "matches": n,
                                    "accepted": accepted})
            if accepted:
                self.loop_edges.append((i, j))
                self._graph_loops.append((j, i, R, p))

    # ------------------------------------------------------------------
    def optimized_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """Optimize the pose graph; returns the corrected (Rs, ps).

        Loop edges pass a median-consensus gate first: a registration can
        lock onto aliased geometry with a low RMS, and one such edge at loop
        weight warps the whole graph.  Each edge's translation residual
        against the odometry is compared with the edges' median: genuine
        drift corrections share the odometry's systematic error, an alias is
        an isolated outlier.  Rejected edges are counted in
        `consensus_rejected`."""
        frames = self.keyframes.frames
        if len(frames) < 2:
            return self.keyframes.positions(False), self.keyframes.positions(False)
        Rs = np.stack([f.R for f in frames]).astype(np.float32)
        ps = np.stack([f.p for f in frames]).astype(np.float32)
        loops = self._graph_loops
        self.consensus_rejected = 0
        if loops:
            res = []
            for (j, i, R, p) in loops:
                fi, fj = frames[i], frames[j]
                res.append(float(np.linalg.norm(p - fj.R.T @ (fi.p - fj.p))))
            gate = max(3.0 * float(np.median(res)), 0.5)
            kept = [e for e, r in zip(loops, res) if r <= gate]
            self.consensus_rejected = len(loops) - len(kept)
            loops = kept
        g = PoseGraph()
        g.add_odometry_chain(Rs, ps)
        for (j, i, R, p) in loops:
            g.add_edge(j, i, R, p, weight=50.0)
        Rs2, ps2, _ = optimize_pose_graph(g, Rs, ps, iters=10, device=self.device)
        for f, R, p in zip(frames, Rs2, ps2):
            f.R_opt, f.p_opt = R, p
        return Rs2, ps2
