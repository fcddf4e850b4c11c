"""A Velodyne scan as the node's callback decodes it: a frozen copy of
`limovelo_tpu_torch/io/pointcloud.decode_scan` (velodyne branch) and of the
numpy form of its native temporal downsample, min-range filter and time
sort (`limovelo_tpu_torch/native.process_scan_plain`)."""

from __future__ import annotations

import numpy as np


def process_scan(xyz, t, downsample_rate: int, min_dist: float, intensity):
    """Every `downsample_rate`-th point by a running counter, finite and
    farther than `min_dist`, stably sorted by time."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    t = np.ascontiguousarray(t, np.float64)
    n = len(xyz)
    counter = np.arange(1, n + 1)
    keep = np.ones(n, bool) if downsample_rate <= 1 else (counter % downsample_rate) == 0
    keep &= np.isfinite(xyz).all(axis=1)
    keep &= (xyz.astype(np.float64) ** 2).sum(1) > min_dist * min_dist
    idx = np.nonzero(keep)[0]
    order = idx[np.argsort(t[idx], kind="stable")]
    return xyz[order], t[order], np.asarray(intensity, np.float32)[order]


def decode_velodyne(config, xyz, header_stamp: float, rel, intensity):
    """Relative per-point times → absolute (offsets from the rotation's start
    with `offset_beginning`, else from its end; the header stamp at the
    rotation's start with `stamp_beginning`, else at its end), then
    `process_scan`."""
    rel = np.asarray(rel, np.float64)
    if not config.offset_beginning:
        rel = rel + config.full_rotation_time
    if len(rel):
        begin = header_stamp if config.stamp_beginning else header_stamp - (rel[-1] - rel[0])
        t_abs = begin + (rel - rel[0])
    else:
        t_abs = rel
    return process_scan(xyz, t_abs, config.downsample_rate, config.min_dist, intensity)
