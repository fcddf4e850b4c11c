"""Observability: structured per-step metrics, trajectory streaming, and an
optional ROS bridge (a copy of `limovelo_tpu/runtime/publishers.py`, which
the port must not import).

Analog of the reference's `Publishers` (`include/Headers/Publishers.hpp`):
where the reference advertises 8 ROS topics (state odometry incl. body-frame
velocity, pose array, window cloud, map stream, plane normals, velocity,
yaw, TF), this module emits the same information as structured records —
JSONL metrics, TUM trajectory streaming, and callbacks that a ROS1/ROS2
bridge can subscribe to without the core depending on ROS.  numpy and scipy
only: the pipeline hands every packet over as host arrays.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, TextIO

import numpy as np
from scipy.spatial.transform import Rotation as Rsc


@dataclass
class PlanesPacket:
    """Equivalent content to /limovelo/planes PoseArray (Publishers.hpp:92-116):
    one pose per chosen match — position at the plane's neighbor centroid,
    orientation rotating +x onto the plane normal (the reference's quaternion
    (0, −C, B, ‖n‖+A), normalized)."""

    t: float
    centroids: np.ndarray   # (M, 3)
    normals: np.ndarray     # (M, 3) unit

    def quaternions(self) -> np.ndarray:
        """(M, 4) quats (x,y,z,w) rotating +x onto each normal, matching the
        reference's construction."""
        A, B, C = self.normals[:, 0], self.normals[:, 1], self.normals[:, 2]
        q = np.stack([np.zeros_like(A), -C, B, 1.0 + A], axis=-1)
        n = np.linalg.norm(q, axis=-1, keepdims=True)
        # normal ≈ (−1,0,0) is a 180° rotation; any perpendicular axis works
        deg = (n[:, 0] < 1e-6)
        q[deg] = (0.0, 0.0, 1.0, 0.0)
        n[deg] = 1.0
        return q / n


@dataclass
class PoseArrayPacket:
    """Equivalent content to /limovelo/states PoseArray (Publishers.hpp:47-69):
    the recent corrected states (BUFFER_X analog)."""

    t: float
    times: np.ndarray       # (M,)
    positions: np.ndarray   # (M, 3)
    quaternions: np.ndarray # (M, 4) (x,y,z,w)


@dataclass
class TfPacket:
    """Equivalent content to the reference's TF broadcast map→body
    (Publishers.hpp:118-135): a stamped rigid transform between two frames."""

    t: float
    parent: str            # "map"
    child: str             # "body"
    translation: np.ndarray  # (3,)
    quaternion: np.ndarray   # (4,) (x,y,z,w)


@dataclass
class ExtrinsicsPacket:
    """Online extrinsics estimate (publish.extrinsics / print_extrinsics,
    main.cpp:96, Publishers.hpp:202-218): LiDAR→IMU rotation + translation."""

    t: float
    rotvec: np.ndarray     # (3,) Log(R_LI)
    translation: np.ndarray  # (3,) t_LI


@dataclass
class StatePacket:
    """Equivalent content to /limovelo/state Odometry (Publishers.hpp:174-200):
    pose + body-frame velocity + yaw, stamped."""

    t: float
    p: np.ndarray
    q: np.ndarray          # (x,y,z,w)
    v_world: np.ndarray
    v_body: np.ndarray
    yaw_deg: float


class Publisher:
    """Fan-out sink for pipeline outputs.

    Attach callbacks (`on_state`, `on_cloud`) or file sinks (JSONL metrics,
    streaming TUM trajectory).  All methods are cheap no-ops when nothing is
    attached, so the pipeline can call unconditionally.
    """

    def __init__(
        self,
        metrics_path: Optional[str] = None,
        trajectory_path: Optional[str] = None,
        log_degeneracy: bool = False,
        log_extrinsics: bool = False,
    ):
        self._metrics: Optional[TextIO] = open(metrics_path, "w") if metrics_path else None
        self._traj: Optional[TextIO] = open(trajectory_path, "w") if trajectory_path else None
        # JSONL verbosity — the print_degeneracy_values / print_extrinsics
        # analogs (main.cpp:96,156): eigenvalues and extrinsics go into the
        # metrics stream only when asked for
        self.log_degeneracy = log_degeneracy
        self.log_extrinsics = log_extrinsics
        self.on_state: List[Callable[[StatePacket], None]] = []
        self.on_tf: List[Callable[[TfPacket], None]] = []
        self.on_cloud: List[Callable[[np.ndarray, float], None]] = []
        self.on_full_cloud: List[Callable[[np.ndarray, float], None]] = []
        self.on_planes: List[Callable[[PlanesPacket], None]] = []
        self.on_states: List[Callable[[PoseArrayPacket], None]] = []
        self.on_extrinsics: List[Callable[[ExtrinsicsPacket], None]] = []

    # ------------------------------------------------------------------
    def state(self, record) -> StatePacket:
        """Publish one state update (per correct(); main.cpp:87)."""
        R = np.asarray(record.R)
        q = Rsc.from_matrix(R).as_quat()
        v_world = np.asarray(record.v)
        pkt = StatePacket(
            t=record.t,
            p=np.asarray(record.p),
            q=q,
            v_world=v_world,
            v_body=R.T @ v_world,
            yaw_deg=math.degrees(math.atan2(R[1, 0], R[0, 0])),
        )
        for cb in self.on_state:
            cb(pkt)
        if self.on_tf:
            # TF broadcast map→body rides with every state (main.cpp:88)
            tf = TfPacket(t=record.t, parent="map", child="body",
                          translation=pkt.p, quaternion=q)
            for cb in self.on_tf:
                cb(tf)
        if self._traj is not None:
            p = pkt.p
            self._traj.write(
                f"{pkt.t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
            self._traj.flush()
        if self._metrics is not None:
            row = {
                "t": record.t,
                "updated": record.updated,
                "ds_count": record.ds_count,
                "matches": record.num_matches,
                "mean_residual": record.mean_residual,
                "iterations": record.iterations,
                "wall_ms": record.wall_ms,
                "p": np.asarray(record.p).round(6).tolist(),
                "v_body": pkt.v_body.round(6).tolist(),
                "yaw_deg": round(pkt.yaw_deg, 4),
                "map_points": getattr(record, "map_points", 0),
                "map_dropped": getattr(record, "map_dropped", 0),
            }
            if self.log_degeneracy:
                row["eigenvalues"] = (
                    np.asarray(record.eigenvalues).round(4).tolist()
                )
                row["delta_norm"] = round(float(record.delta_norm), 8)
            if self.log_extrinsics:
                row["extr_rotvec"] = np.asarray(record.extr_rotvec).round(8).tolist()
                row["extr_t"] = np.asarray(record.extr_t).round(6).tolist()
            self._metrics.write(json.dumps(row) + "\n")
            self._metrics.flush()
        return pkt

    @staticmethod
    def _dispatch_cloud(cbs, pts, t, intensity):
        """Call cloud callbacks: 3-arg callbacks get the per-point intensity
        channel (reference clouds carry intensity, Point.cpp:172-175);
        2-arg legacy callbacks get (pts, t)."""
        import inspect

        for cb in cbs:
            try:
                n_par = len(inspect.signature(cb).parameters)
            except (TypeError, ValueError):
                n_par = 2
            if n_par >= 3:
                cb(pts, t, intensity)
            else:
                cb(pts, t)

    def cloud(self, pts: np.ndarray, t: float, intensity: np.ndarray = None):
        """Publish the window cloud — /limovelo/pcl (main.cpp:93)."""
        self._dispatch_cloud(self.on_cloud, pts, t, intensity)

    def full_cloud(self, pts: np.ndarray, t: float, intensity: np.ndarray = None):
        """Publish the map stream — /limovelo/full_pcl (main.cpp:102-116):
        the full-resolution compensated cloud when high_quality_publish, the
        downsampled one otherwise; in offline mode, the re-deskewed full
        rotation at map cadence."""
        self._dispatch_cloud(self.on_full_cloud, pts, t, intensity)

    def extrinsics(self, record) -> ExtrinsicsPacket:
        """Publish the online extrinsics estimate (print_extrinsics,
        main.cpp:96)."""
        pkt = ExtrinsicsPacket(
            t=record.t,
            rotvec=np.asarray(record.extr_rotvec),
            translation=np.asarray(record.extr_t),
        )
        for cb in self.on_extrinsics:
            cb(pkt)
        return pkt

    @property
    def wants_planes(self) -> bool:
        """The pipeline checks this before paying the device→host pull of the
        per-point plane arrays (they stay on device otherwise)."""
        return bool(self.on_planes)

    def planes(self, centroids: np.ndarray, normals: np.ndarray, t: float):
        """Publish the chosen matches' planes (publish_planes,
        Publishers.hpp:92-116)."""
        pkt = PlanesPacket(t=t, centroids=centroids, normals=normals)
        for cb in self.on_planes:
            cb(pkt)

    def loop(self, t: float, i: int, j: int, rms: float, n_matches: int,
             accepted: bool):
        """Publish a loop-closure attempt (beyond-reference backend event);
        lands in the JSONL metrics stream as an `event: loop` row so long-run
        drift correction is observable alongside the per-step records."""
        if self._metrics is not None:
            self._metrics.write(json.dumps({
                "event": "loop", "t": float(t), "i": int(i), "j": int(j),
                "rms": round(float(rms), 6), "matches": int(n_matches),
                "accepted": bool(accepted),
            }) + "\n")
            self._metrics.flush()

    def states(self, times: np.ndarray, positions: np.ndarray, rotations: np.ndarray, t: float):
        """Publish the recent corrected states as a pose array
        (/limovelo/states; Publishers.hpp:47-69)."""
        if not self.on_states:
            return
        quats = (
            Rsc.from_matrix(rotations).as_quat()
            if len(rotations)
            else np.zeros((0, 4))
        )
        pkt = PoseArrayPacket(
            t=t, times=np.asarray(times), positions=np.asarray(positions),
            quaternions=quats,
        )
        for cb in self.on_states:
            cb(pkt)

    def close(self):
        for f in (self._metrics, self._traj):
            if f is not None:
                f.close()


def make_ros1_bridge(publisher: Publisher, frame_id: str = "map"):
    """Attach rospy publishers mirroring the reference topics, if rospy is
    importable (optional; the core never imports ROS)."""
    try:
        import rospy  # noqa: F401
        from geometry_msgs.msg import PoseStamped  # noqa: F401
        from nav_msgs.msg import Odometry
    except ImportError as e:  # pragma: no cover - ROS not in this image
        raise RuntimeError("rospy not available; ROS bridge disabled") from e

    odom_pub = rospy.Publisher("/limovelo/state", Odometry, queue_size=10)

    def _send(pkt: StatePacket):  # pragma: no cover
        msg = Odometry()
        msg.header.stamp = rospy.Time.from_sec(pkt.t)
        msg.header.frame_id = frame_id
        msg.pose.pose.position.x, msg.pose.pose.position.y, msg.pose.pose.position.z = pkt.p
        (msg.pose.pose.orientation.x, msg.pose.pose.orientation.y,
         msg.pose.pose.orientation.z, msg.pose.pose.orientation.w) = pkt.q
        (msg.twist.twist.linear.x, msg.twist.twist.linear.y,
         msg.twist.twist.linear.z) = pkt.v_body
        odom_pub.publish(msg)

    publisher.on_state.append(_send)
    return publisher
