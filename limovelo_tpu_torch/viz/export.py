"""Point-cloud / trajectory export for external viewers (PLY); a copy of
`limovelo_tpu/viz/export.py`.

The reference visualizes exclusively through rviz over live ROS topics; a
headless run instead dumps its artifacts — the HD map and the estimated
trajectory — as standard binary-little-endian PLY files that CloudCompare,
meshlab, or Open3D open directly.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def write_ply(path: str, pts: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write (N,3) float points (optionally with (N,3) uint8 colors) as
    binary_little_endian PLY."""
    pts = np.ascontiguousarray(np.asarray(pts, np.float32))
    n = len(pts)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.ascontiguousarray(np.asarray(colors, np.uint8))
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is None:
            f.write(pts.tobytes())
        else:
            rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"], rec["rgb"] = pts, colors
            f.write(rec.tobytes())


def read_ply_header(path: str):
    """Parse a PLY header → (vertex_count, has_color).  For tests/tools."""
    count, has_color = 0, False
    with open(path, "rb") as f:
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: truncated/malformed file
                raise ValueError(f"PLY header not terminated: {path}")
            line = raw.decode().strip()
            if line.startswith("element vertex"):
                count = int(line.split()[-1])
            if line == "property uchar red":
                has_color = True
            if line == "end_header":
                return count, has_color


def height_colors(pts: np.ndarray) -> np.ndarray:
    """Sequential single-hue (blue, light→dark) color ramp over z — magnitude
    encoding per the viz color rules; robust to outliers via 2-98 pct."""
    z = np.asarray(pts)[:, 2]
    lo, hi = np.percentile(z, 2), np.percentile(z, 98)
    t = np.clip((z - lo) / max(hi - lo, 1e-9), 0.0, 1.0)[:, None]
    light = np.array([219.0, 234.0, 254.0])   # light blue
    dark = np.array([30.0, 64.0, 175.0])      # dark blue
    return (light + t * (dark - light)).astype(np.uint8)


def intensity_colors(intensity: np.ndarray) -> np.ndarray:
    """Grayscale ramp over per-point intensity/reflectivity (robust 2-98 pct)
    — the viewer-grade coloring the reference's intensity channel exists for
    (Point.cpp:172-175)."""
    v = np.asarray(intensity, np.float64)
    lo, hi = np.percentile(v, 2), np.percentile(v, 98)
    t = np.clip((v - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    g = (40.0 + t * 215.0).astype(np.uint8)
    return np.stack([g, g, g], axis=1)


def trajectory_to_ply(path: str, positions: np.ndarray):
    """Export a trajectory as an orange polyline-ish PLY (dense vertices)."""
    p = np.asarray(positions, np.float32)
    colors = np.tile(np.array([234, 88, 12], np.uint8), (len(p), 1))
    write_ply(path, p, colors)
