"""Vendor point-cloud decoding with per-point absolute timestamps (a copy of
`limovelo_tpu/io/pointcloud.py`, which the port must not import).

Analog of the reference's `PointCloudProcessor` + the vendor `Point`
constructors (`src/Utils/PointCloudProcessor.cpp`, `src/Objects/Point.cpp:
38-111`): turn a raw scan (plain arrays from a rosbag or dataset reader) into
`(pts (N,3) f32, t (N,) f64)` with *absolute* per-point stamps, applying the
reference's timestamp semantics per vendor:

- **velodyne**: per-point `time` is relative.  With `offset_beginning` the
  offsets are measured from the start of the rotation (t ∈ [0, T]); otherwise
  from the end (t ∈ [-T, 0]) and `full_rotation_time` is added
  (Point.cpp:55-60).  The absolute base is the header stamp shifted so the
  earliest point lands on it (stamp at beginning vs end of rotation via
  `stamp_beginning`, PointCloudProcessor.cpp:43-47).
- **ouster**: same as velodyne but offsets in nanoseconds (`t` field,
  Point.cpp:70-79).
- **hesai**: per-point `timestamp` is already absolute (Point.cpp:37-44).
- **custom**: absolute `timestamp` field by default.

Then the temporal downsample + min-range filter + time sort
(PointCloudProcessor.cpp:101-123) in the native library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..native import process_scan
from ..runtime import profiling


def decode_scan(
    config,
    xyz: np.ndarray,
    header_stamp: float,
    time_field: Optional[np.ndarray] = None,
    lidar_type: Optional[str] = None,
    intensity: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, ...]:
    """Decode one scan → (pts (N,3) f32, t (N,) f64 absolute[, intensity]),
    processed.

    `time_field` carries the vendor per-point time: relative seconds
    (velodyne), relative nanoseconds (ouster), absolute seconds (hesai/
    custom), or None (no per-point time → all stamps 0, which triggers the
    runtime's missing-time fallback).

    `intensity` (velodyne/hesai `intensity`, ouster `reflectivity` —
    Point.cpp:172-175) rides through the filter and sort; when given, a
    3-tuple is returned."""
    with profiling.span("ingest.decode"):
        lidar_type = (lidar_type or config.LiDAR_type).lower()
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        n = len(xyz)

        if time_field is None:
            t_abs = np.zeros(n, np.float64)  # all-zero ⇒ missing-time fallback
        elif lidar_type == "velodyne":
            rel = np.asarray(time_field, np.float64)
            if not config.offset_beginning:
                rel = rel + config.full_rotation_time
            t_abs = _rebase_relative(config, rel, header_stamp)
        elif lidar_type == "ouster":
            rel = np.asarray(time_field, np.float64) * 1e-9
            if not config.offset_beginning:
                rel = rel + config.full_rotation_time
            t_abs = _rebase_relative(config, rel, header_stamp)
        elif lidar_type in ("hesai", "custom"):
            t_abs = np.asarray(time_field, np.float64)
        else:
            raise ValueError(f"Unknown LiDAR type {lidar_type!r}! Check your config.")

        return process_scan(xyz, t_abs, config.downsample_rate, config.min_dist,
                            intensity=intensity)


def _rebase_relative(config, rel: np.ndarray, header_stamp: float) -> np.ndarray:
    """Relative stamps → absolute, matching get_begin_time
    (PointCloudProcessor.cpp:42-47): begin = stamp + rel[first] (stamp at
    beginning of rotation) or stamp + rel[first] − rel[last] (stamp at end)."""
    if len(rel) == 0:
        return rel
    if config.stamp_beginning:
        begin = header_stamp
    else:
        begin = header_stamp - (rel[-1] - rel[0])
    return begin + (rel - rel[0])
