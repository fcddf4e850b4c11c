"""A cell of the benchmark cut to a size the CPU tests can run: the cell's
own files with a 16 x 256 sensor, a 24 m room, a 4 m ring (a lap of 2 s)
and a 2^14-bucket map."""

from __future__ import annotations

import copy

from lio_bench.cells import load


def tiny_cell(name: str = "kitti_hdl64.online", limits=None):
    cell = copy.deepcopy(load(*name.split(".", 1)))
    c = cell.config
    c["sensor"].update(beams=16, azimuths=256)
    c["scene"].update(size_m=24.0, n_boxes=10)
    c["course"].update(radius_m=4.0, lap_s=2.0, hold_s=0.5, ramp_s=1.0)
    c["profile_overrides"]["map_table_size"] = 1 << 14
    if limits is not None:
        cell.limits = dict(limits)
    return cell
