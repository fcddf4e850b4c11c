"""Dataset-format fixture writers: KITTI raw drives and ROS1 v2.0 bags (a
copy of `limovelo_tpu/io/fixtures.py` on top of the port's simulator; the
port must not import the JAX package).

No KITTI drive or rosbag ships with the repository, so accuracy evidence
flows through the real reader and decoder paths on synthesized data in the
genuine container formats:

- `write_kitti_drive`: renders a drive with the simulator using the
  configuration's extrinsics and the HDL-64 sweep convention (clockwise from
  the rear — `io/kitti.py` reconstructs per-point time from azimuth, so the
  sweep direction is load-bearing), then writes the standard raw-sync layout:
  velodyne .bin + timestamps{,_start,_end}.txt + OXTS records.
- `write_rosbag`: serializes simulator output as a ROS1 v2.0 bag (chunked,
  uncompressed) with `sensor_msgs/PointCloud2` (x,y,z,intensity,time fields,
  velodyne relative-stamp semantics) and `sensor_msgs/Imu` messages — the
  containers `io/rosbag.py` parses.

Both return or take the ground truth needed for ATE, so a replay through
`python -m limovelo_tpu_torch kitti|run` can be scored end to end.  Given the
same `SimData`, both write the bytes the JAX package's writers write.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

from .simulate import SimData, Trajectory, simulate

# ---------------------------------------------------------------------------
# KITTI raw drive
# ---------------------------------------------------------------------------

_KITTI_EPOCH = 1316000000.0  # arbitrary absolute base for timestamp files


def _fmt_kitti_stamp(t: float) -> str:
    """Absolute seconds → 'YYYY-MM-DD HH:MM:SS.sssssssss' (UTC)."""
    import datetime as dt

    d = dt.datetime.fromtimestamp(int(t), tz=dt.timezone.utc)
    frac = t - int(t)
    return d.strftime("%Y-%m-%d %H:%M:%S") + f".{int(round(frac * 1e9)):09d}"


def kitti_azimuths(cols: int) -> np.ndarray:
    """HDL-64 column azimuths: the scanner sweeps CLOCKWISE starting at the
    rear, so `-arctan2(y, x)` increases linearly over the scan — the exact
    relation `KittiRawReader.scans` inverts (io/kitti.py)."""
    return np.pi - 2 * np.pi * np.arange(cols) / cols


def write_kitti_drive(
    out_dir: str,
    world_cast,
    traj: Trajectory,
    config,
    duration: float = 5.0,
    lidar_lines: int = 16,
    pts_per_line: int = 256,
    seed: int = 0,
    range_noise: float = 0.01,
) -> SimData:
    """Render + write a KITTI raw-sync drive directory; returns the SimData
    (ground truth in `gt_t/gt_R/gt_p`) for ATE evaluation."""
    imu_rate = float(config.imu_rate)
    # NOTE: `simulate` evaluates the trajectory in t_start-local time itself
    # (analytic trajectories lose all precision at absolute-epoch arguments:
    # second differences at t ≈ 1.3e9 s are pure cancellation noise), so the
    # raw trajectory is passed through unwrapped
    sim = simulate(
        world_cast, traj, config,
        duration=duration, t_start=_KITTI_EPOCH,
        lidar_lines=lidar_lines, pts_per_line=pts_per_line,
        imu_rate=imu_rate, seed=seed, range_noise=range_noise,
        azimuths=kitti_azimuths(pts_per_line),
    )

    velo = os.path.join(out_dir, "velodyne_points")
    oxts = os.path.join(out_dir, "oxts")
    os.makedirs(os.path.join(velo, "data"), exist_ok=True)
    os.makedirs(os.path.join(oxts, "data"), exist_ok=True)

    rot = config.full_rotation_time
    with open(os.path.join(velo, "timestamps.txt"), "w") as f_mid, \
         open(os.path.join(velo, "timestamps_start.txt"), "w") as f_s, \
         open(os.path.join(velo, "timestamps_end.txt"), "w") as f_e:
        for i, scan in enumerate(sim.scans):
            pts4 = np.zeros((len(scan.pts), 4), np.float32)
            pts4[:, :3] = scan.pts
            if scan.intensity is not None:
                pts4[:, 3] = scan.intensity   # KITTI reflectance column
            pts4.tofile(os.path.join(velo, "data", f"{i:010d}.bin"))
            f_s.write(_fmt_kitti_stamp(scan.stamp) + "\n")
            f_mid.write(_fmt_kitti_stamp(scan.stamp + rot / 2) + "\n")
            f_e.write(_fmt_kitti_stamp(scan.stamp + rot) + "\n")

    # OXTS: 30-field records; the reader consumes lat/lon/alt (0:3 — the
    # GPS ground-truth channel `oxts_trajectory` inverts via the devkit
    # mercator projection), roll/pitch/yaw (3:6), body accelerations (11:14)
    # and body rates (17:20).  lat/lon are synthesized by the INVERSE of the
    # devkit formula around a KITTI-plausible origin so the real GT-derivation
    # path is exercised end-to-end.
    g_world = np.array(config.gravity_vec, np.float64)
    lat0 = np.deg2rad(49.0)
    er = 6378137.0
    scale = np.cos(lat0)
    with open(os.path.join(oxts, "timestamps.txt"), "w") as f_t:
        for i, t in enumerate(sim.imu_t):
            R_b, p_b = traj.pose(t - _KITTI_EPOCH)   # drive-local time
            roll, pitch, yaw = Rsc.from_matrix(R_b).as_euler("xyz")
            rec = np.zeros(30)
            # inverse mercator: x=scale·er·lon, y=scale·er·ln(tan(π/4+lat/2))
            y0 = scale * er * np.log(np.tan(np.pi / 4 + lat0 / 2))
            lon = p_b[0] / (scale * er)
            lat = 2 * np.arctan(np.exp((p_b[1] + y0) / (scale * er))) - np.pi / 2
            rec[0:3] = (np.degrees(lat), np.degrees(lon), p_b[2])
            rec[3:6] = (roll, pitch, yaw)
            rec[11:14] = sim.imu_a[i]
            rec[17:20] = sim.imu_w[i]
            np.savetxt(
                os.path.join(oxts, "data", f"{i:010d}.txt"),
                rec[None], fmt="%.12f",
            )
            f_t.write(_fmt_kitti_stamp(t) + "\n")
    return sim


# ---------------------------------------------------------------------------
# ROS1 v2.0 bag writer
# ---------------------------------------------------------------------------


def _header(fields: List[Tuple[bytes, bytes]]) -> bytes:
    out = b""
    for k, v in fields:
        item = k + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(fields: List[Tuple[bytes, bytes]], data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ros_time(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return struct.pack("<II", sec, nsec)


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def serialize_pointcloud2(stamp: float, xyz: np.ndarray, time_rel: np.ndarray,
                          seq: int, frame_id: str = "velodyne",
                          intensity: np.ndarray = None) -> bytes:
    """sensor_msgs/PointCloud2 with x,y,z,intensity,time float32 fields
    (the velodyne driver layout)."""
    n = len(xyz)
    fields = [("x", 0), ("y", 4), ("z", 8), ("intensity", 12), ("time", 16)]
    body = struct.pack("<I", seq) + _ros_time(stamp) + _ros_string(frame_id)
    body += struct.pack("<II", 1, n)            # height, width
    body += struct.pack("<I", len(fields))
    for name, off in fields:
        body += _ros_string(name)
        body += struct.pack("<IBI", off, 7, 1)  # offset, FLOAT32, count
    point_step = 20
    data = np.zeros((n, 5), np.float32)
    data[:, :3] = xyz
    if intensity is not None:
        data[:, 3] = intensity
    data[:, 4] = time_rel
    raw = data.tobytes()
    body += struct.pack("<B", 0)                # is_bigendian
    body += struct.pack("<II", point_step, point_step * n)
    body += struct.pack("<I", len(raw)) + raw
    body += struct.pack("<B", 1)                # is_dense
    return body


def serialize_imu(stamp: float, q, w, a, seq: int, frame_id: str = "imu") -> bytes:
    """sensor_msgs/Imu (orientation + covariances + rates + accels)."""
    body = struct.pack("<I", seq) + _ros_time(stamp) + _ros_string(frame_id)
    body += struct.pack("<4d", *q)              # x,y,z,w
    body += struct.pack("<9d", *([0.0] * 9))
    body += struct.pack("<3d", *w)
    body += struct.pack("<9d", *([0.0] * 9))
    body += struct.pack("<3d", *a)
    body += struct.pack("<9d", *([0.0] * 9))
    return body


def write_rosbag(
    path: str,
    sim: SimData,
    config,
    points_topic: Optional[str] = None,
    imus_topic: Optional[str] = None,
    chunk_msgs: int = 64,
) -> None:
    """Write simulator output as a ROS1 v2.0 bag (uncompressed chunks).

    Per-point `time` fields follow the config's velodyne stamp semantics
    (offset_beginning / stamp_beginning, Point.cpp:55-60 +
    PointCloudProcessor.cpp:42-47) so `decode_scan` recovers the true
    absolute per-point times exactly.
    """
    points_topic = points_topic or config.points_topic
    imus_topic = imus_topic or config.imus_topic
    rot = config.full_rotation_time

    # interleave messages in time order
    events = []  # (t, kind, payload)
    for scan in sim.scans:
        if len(scan.t) == 0:
            continue
        t0 = float(scan.t[0])
        rel = (scan.t - t0).astype(np.float32)  # offsets from rotation start
        if not config.offset_beginning:
            rel = rel - rot                      # driver measures from the end
        span = float(rel[-1] - rel[0])
        stamp = t0 if config.stamp_beginning else t0 + span
        events.append((stamp, "pc", (stamp, scan.pts, rel, scan.intensity)))
    # orientation from ground truth (nearest dense sample) — the reference's
    # IMUs carry a quaternion the pipeline seeds its initial attitude from
    for i, t in enumerate(sim.imu_t):
        gi = int(np.argmin(np.abs(sim.gt_t - t)))
        q = tuple(Rsc.from_matrix(sim.gt_R[gi]).as_quat())
        events.append((float(t), "imu", (float(t), q, sim.imu_w[i], sim.imu_a[i])))
    events.sort(key=lambda e: e[0])

    conn_pc = _record(
        [(b"op", b"\x07"), (b"conn", struct.pack("<I", 0)),
         (b"topic", points_topic.encode())],
        _header([
            (b"topic", points_topic.encode()),
            (b"type", b"sensor_msgs/PointCloud2"),
            (b"md5sum", b"1158d486dd51d683ce2f1be655c3c181"),
            (b"message_definition", b""),
        ]),
    )
    conn_imu = _record(
        [(b"op", b"\x07"), (b"conn", struct.pack("<I", 1)),
         (b"topic", imus_topic.encode())],
        _header([
            (b"topic", imus_topic.encode()),
            (b"type", b"sensor_msgs/Imu"),
            (b"md5sum", b"6a62c6daae103f4ff57a132d6f95cec2"),
            (b"message_definition", b""),
        ]),
    )

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header record (op=0x03), padded to 4096 like real bags
        bh = _record(
            [(b"op", b"\x03"), (b"index_pos", struct.pack("<Q", 0)),
             (b"conn_count", struct.pack("<I", 2)),
             (b"chunk_count", struct.pack("<I",
                                          (len(events) + chunk_msgs - 1) // chunk_msgs))],
            b" " * 4096,
        )
        f.write(bh)

        seq = 0
        for start in range(0, len(events), chunk_msgs):
            chunk = b""
            if start == 0:
                chunk += conn_pc + conn_imu
            for t, kind, payload in events[start:start + chunk_msgs]:
                if kind == "pc":
                    stamp, pts, rel, inten = payload
                    raw = serialize_pointcloud2(stamp, pts, rel, seq,
                                                intensity=inten)
                    cid = 0
                else:
                    stamp, q, w, a = payload
                    raw = serialize_imu(stamp, q, w, a, seq)
                    cid = 1
                seq += 1
                chunk += _record(
                    [(b"op", b"\x02"), (b"conn", struct.pack("<I", cid)),
                     (b"time", _ros_time(stamp))],
                    raw,
                )
            f.write(_record(
                [(b"op", b"\x05"), (b"compression", b"none"),
                 (b"size", struct.pack("<I", len(chunk)))],
                chunk,
            ))
        # trailing connection records (the index section of real bags)
        f.write(conn_pc)
        f.write(conn_imu)
