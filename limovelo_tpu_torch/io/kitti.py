"""KITTI raw-sync dataset reader: Velodyne HDL-64 + OXTS IMU/GPS (a copy of
`limovelo_tpu/io/kitti.py`, which the port must not import).

Feeds the pipeline the same data the reference consumes through the
`/kitti/velo/pointcloud` + `/kitti/oxts/imu` rosbag topics (the reference's
`config/kitti.yaml:8-9`).  Reads the standard KITTI raw layout:

    <drive>/velodyne_points/data/0000000000.bin   (N,4) float32 x,y,z,refl
    <drive>/velodyne_points/timestamps{,_start,_end}.txt
    <drive>/oxts/data/0000000000.txt              30-field OXTS record
    <drive>/oxts/timestamps.txt

Per-point times for HDL-64 are not stored; they are reconstructed from the
azimuth sweep (the scanner rotates clockwise starting/ending at the back),
using the start/end timestamp files when available — the same information the
kitti2bag-produced clouds carry.
"""

from __future__ import annotations

import datetime as _dt
import math
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

from .pointcloud import decode_scan


def _read_timestamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # 2011-09-26 13:02:25.446213696
            d, t = line.split(" ")
            y, mo, da = map(int, d.split("-"))
            hh, mm, ss = t.split(":")
            sec = float(ss)
            epoch = _dt.datetime(y, mo, da, int(hh), int(mm), tzinfo=_dt.timezone.utc).timestamp()
            out.append(epoch + sec)
    return np.asarray(out, np.float64)


@dataclass
class OxtsRecord:
    t: float
    lat: float
    lon: float
    alt: float
    roll: float
    pitch: float
    yaw: float
    a: np.ndarray   # body accelerations ax,ay,az (fields 11-13)
    w: np.ndarray   # body rates wx,wy,wz (fields 17-19)


class KittiRawReader:
    def __init__(self, drive_dir: str):
        self.dir = drive_dir
        velo = os.path.join(drive_dir, "velodyne_points")
        self.velo_files = sorted(
            os.path.join(velo, "data", f)
            for f in os.listdir(os.path.join(velo, "data"))
            if f.endswith(".bin")
        )
        self.velo_t = _read_timestamps(os.path.join(velo, "timestamps.txt"))
        self.velo_t_start = (
            _read_timestamps(os.path.join(velo, "timestamps_start.txt"))
            if os.path.exists(os.path.join(velo, "timestamps_start.txt"))
            else None
        )
        self.velo_t_end = (
            _read_timestamps(os.path.join(velo, "timestamps_end.txt"))
            if os.path.exists(os.path.join(velo, "timestamps_end.txt"))
            else None
        )
        oxts = os.path.join(drive_dir, "oxts")
        self.oxts_files = sorted(
            os.path.join(oxts, "data", f)
            for f in os.listdir(os.path.join(oxts, "data"))
            if f.endswith(".txt")
        )
        self.oxts_t = _read_timestamps(os.path.join(oxts, "timestamps.txt"))

    # ------------------------------------------------------------------
    def imu(self) -> Iterator[OxtsRecord]:
        for t, f in zip(self.oxts_t, self.oxts_files):
            v = np.loadtxt(f)
            yield OxtsRecord(
                t=float(t),
                lat=v[0], lon=v[1], alt=v[2],
                roll=v[3], pitch=v[4], yaw=v[5],
                a=np.asarray(v[11:14], np.float32),
                w=np.asarray(v[17:20], np.float32),
            )

    def scans(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float, np.ndarray]]:
        """Yields (pts (N,3) f32, t_abs (N,) f64, stamp, reflectance (N,))."""
        for i, f in enumerate(self.velo_files):
            raw = np.fromfile(f, np.float32).reshape(-1, 4)
            pts = raw[:, :3]
            t0 = (
                float(self.velo_t_start[i])
                if self.velo_t_start is not None
                else float(self.velo_t[i]) - 0.05
            )
            t1 = (
                float(self.velo_t_end[i])
                if self.velo_t_end is not None
                else float(self.velo_t[i]) + 0.05
            )
            # reconstruct per-point time from azimuth: HDL-64 spins so that
            # azimuth decreases over the scan, starting at the rear (±pi).
            # f64 throughout: pts are f32 and a weak Python-float t0 would
            # demote t_abs to f32, which cannot represent epoch-scale stamps
            # (eps(f32 @ 1.3e9 s) ≈ 128 s — every per-point time collapses)
            az = -np.arctan2(pts[:, 1].astype(np.float64), pts[:, 0].astype(np.float64))
            frac = (az - az.min()) / max(az.max() - az.min(), 1e-9)
            t_abs = t0 + frac * (t1 - t0)
            yield pts, t_abs, float(self.velo_t[i]), raw[:, 3]


def feed_pipeline(pipe, reader: KittiRawReader, config, max_scans: Optional[int] = None):
    """Interleave IMU + scans into the pipeline in time order, applying the
    PointCloudProcessor filters (min_dist / temporal downsample)."""
    imu_it = reader.imu()
    imu_next = next(imu_it, None)
    n_scans = 0
    rot = float(getattr(config, "full_rotation_time", 0.1))
    for pts, t_abs, stamp, refl in reader.scans():
        # deliver IMUs only up to the scan's COMPLETION time — the arrival
        # model of a live driver, which publishes the cloud when the rotation
        # finishes, with IMU messages interleaved in time order.  Feeding IMU
        # further ahead of the cloud shifts the warm-up windows' phase and
        # degrades the replay.
        while imu_next is not None and imu_next.t <= stamp + rot:
            q = Rsc.from_euler("xyz", [imu_next.roll, imu_next.pitch, imu_next.yaw]).as_quat()
            pipe.add_imu(imu_next.t, imu_next.a, imu_next.w, q=q)
            imu_next = next(imu_it, None)
        # hesai-style: t_abs is already absolute → bypass relative rebasing;
        # the 4th velodyne .bin float is the reflectance channel
        p, t, inten = decode_scan(config, pts, stamp, time_field=t_abs,
                                  lidar_type="hesai", intensity=refl)
        pipe.add_scan(p, t, intensity=inten)
        pipe.spin()
        n_scans += 1
        if max_scans is not None and n_scans >= max_scans:
            break


def oxts_trajectory(reader: KittiRawReader):
    """Ground-truth trajectory from the drive's OXTS GPS/INS channel — the
    KITTI raw devkit's `convertOxtsToPose` mercator projection.

    Returns (t (M,) f64, R (M,3,3) f32, p (M,3) f64) in a local ENU frame
    anchored at the first record (ATE alignment removes the remaining
    gauge).  Works on any *_sync drive: the `eval --kitti-root` ground-truth
    source when no pose file is supplied."""
    ts, Rs, ps = [], [], []
    scale = None
    for rec in reader.imu():
        if scale is None:
            scale = math.cos(math.radians(rec.lat))
        er = 6378137.0
        x = scale * er * math.radians(rec.lon)
        y = scale * er * math.log(math.tan(math.pi / 4 + math.radians(rec.lat) / 2))
        ts.append(rec.t)
        ps.append((x, y, rec.alt))
        Rs.append(Rsc.from_euler("xyz", (rec.roll, rec.pitch, rec.yaw)).as_matrix())
    t = np.asarray(ts, np.float64)
    p = np.asarray(ps, np.float64)
    p -= p[0]
    return t, np.asarray(Rs, np.float32), p
