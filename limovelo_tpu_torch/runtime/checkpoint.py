"""Checkpoint / resume and HD-map save/load (port of
`limovelo_tpu/runtime/checkpoint.py`).

The files are the JAX package's: the same npz keys and dtypes, so each
package loads the other's.

- `save_checkpoint`/`load_checkpoint`: the whole pipeline state (hash-grid
  map, filter state and covariance, time bookkeeping, the corrected-state
  history and the accumulator's buffered sensors) in one compressed npz; a
  resumed run continues like the uninterrupted one.
- `save_map`/`load_map`: the map alone, compacted to its occupied points (an
  HD map); `LioPipeline.from_hd_map` localizes against one.

Saving copies every tensor to the host before it returns, so the next step
may write the map's tables in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.state import NavState
from ..mapping.hashgrid import FAR, GridParams, HashGridMap, insert, make_map

_NAV_FIELDS = ("R", "p", "v", "bg", "ba", "g", "R_LI", "t_LI")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _map_to_host(m: HashGridMap) -> dict:
    return {k: _host(v) for k, v in m._asdict().items()}


def compact_map_points(m: HashGridMap) -> np.ndarray:
    """The occupied map points as a dense (N,3) array (an HD map), in table
    order."""
    occ = torch.isfinite(m.cell_d2).reshape(-1)
    return _host(m.pts.reshape(-1, 3)[occ])


def save_map(path: str, m: HashGridMap, grid: GridParams) -> None:
    """Save the compacted HD map (points + grid geometry)."""
    np.savez_compressed(
        path,
        points=compact_map_points(m),
        voxel_size=grid.voxel_size,
        coarse_factor=grid.coarse_factor,
    )


def load_map(path: str, grid: GridParams, device="cuda", batch: int = 16384) -> HashGridMap:
    """Rebuild a hash-grid map on `device` from a saved HD map, inserting
    the points in padded batches of `batch`."""
    dev = resolve_device(device)
    pts = np.load(path)["points"].astype(np.float32)
    m = make_map(grid, device=dev)
    for i in range(0, len(pts), batch):
        chunk = pts[i:i + batch]
        pad = np.zeros((batch, 3), np.float32)
        pad[:len(chunk)] = chunk
        msk = np.zeros(batch, bool)
        msk[:len(chunk)] = True
        m = insert(m, torch.as_tensor(pad, device=dev), torch.as_tensor(msk, device=dev), grid,
                   downsample=True)
    return m


def _nav_to_host(x: NavState, prefix: str) -> dict:
    return {prefix + f: _host(getattr(x, f)) for f in _NAV_FIELDS}


def _nan_if_none(v):
    return np.nan if v is None else v


def save_checkpoint(path: str, pipe) -> None:
    """Serialize the pipeline's state for an exact resume: filter, map, time
    bookkeeping, the resolved corrected-state history (`_anchors`, which the
    offline re-deskew needs), the mapping and prune cadence, and the
    accumulator's buffered points and IMUs."""
    pipe.flush()
    anc = pipe._anchors
    anc_arrays = {}
    if anc:
        anc_arrays["anchors_t"] = np.array([a.t for a in anc], np.float64)
        for f in _NAV_FIELDS:
            anc_arrays["anchors_" + f] = np.stack([_host(getattr(a.x, f)) for a in anc])
        anc_arrays["anchors_a"] = np.stack([np.asarray(a.a) for a in anc])
        anc_arrays["anchors_w"] = np.stack([np.asarray(a.w) for a in anc])

    acc = pipe.accum
    acc_arrays = {}
    if acc._imu_t:
        acc_arrays["acc_imu_t"] = np.asarray(acc._imu_t, np.float64)
        acc_arrays["acc_imu_a"] = np.stack(acc._imu_a)
        acc_arrays["acc_imu_w"] = np.stack(acc._imu_w)
        acc_arrays["acc_imu_q"] = np.stack([q if q is not None else np.full(4, np.nan)
                                            for q in acc._imu_q])
    if acc._pts:
        acc_arrays["acc_pts"] = np.concatenate(acc._pts)
        acc_arrays["acc_pts_t"] = np.concatenate(acc._pts_t)
        acc_arrays["acc_pts_i"] = np.concatenate(acc._pts_i)

    np.savez_compressed(
        path,
        **_nav_to_host(pipe.x, ""),
        P=_host(pipe.P),
        **_nav_to_host(pipe.anchor, "a"),
        t2=pipe.t2, last_updated=pipe.last_time_updated,
        last_integrated=pipe.last_time_integrated, anchor_t=pipe.anchor_t,
        initial_time=acc.initial_time,
        last_map_time=_nan_if_none(pipe.last_map_time),
        last_processed_t2=pipe._last_processed_t2,
        last_prune_t=_nan_if_none(pipe._last_prune_t),
        missing_point_times=acc.missing_point_times,
        **anc_arrays,
        **acc_arrays,
        **{f"map_{k}": v for k, v in _map_to_host(pipe.map).items()},
    )


def _none_if_nan(v) -> float | None:
    v = float(v)
    return None if np.isnan(v) else v


def load_checkpoint(path: str, pipe) -> None:
    """Restore, in place, the state that `save_checkpoint` of either package
    saved, onto the pipeline's device."""
    from .pipeline import AnchorRec

    dev = pipe.device
    d = np.load(path)
    T = lambda a, dtype=None: torch.as_tensor(np.array(a), dtype=dtype).to(dev)
    nav = lambda prefix: NavState(*(T(d[prefix + f]) for f in _NAV_FIELDS))
    pipe.x = nav("")
    pipe.anchor = nav("a")
    pipe.P = T(d["P"])
    # empty slots must hold the FAR sentinel (the KNN's distance contest
    # has no occupancy mask); older files may hold zeros there
    cell_d2 = np.asarray(d["map_cell_d2"])
    pts = np.where(np.isfinite(cell_d2)[..., None], np.asarray(d["map_pts"]), np.float32(FAR))
    pipe.map = HashGridMap(
        keys=T(d["map_keys"]),
        pts=T(pts),
        cell_d2=T(cell_d2),
        num_points=T(d["map_num_points"]),
        num_buckets=T(d["map_num_buckets"]),
        dropped=T(d["map_dropped"]) if "map_dropped" in d else T(0, torch.int32),
    )
    pipe.t2 = float(d["t2"])
    pipe.last_time_updated = float(d["last_updated"])
    pipe.last_time_integrated = float(d["last_integrated"])
    pipe.anchor_t = float(d["anchor_t"])
    # the device-threaded anchor time (rebased): exact after the pre-save
    # resolution, so the host value restores it
    pipe.anchor_t_dev = T(np.float32(pipe.anchor_t - float(d["initial_time"])))
    pipe.accum.initial_time = float(d["initial_time"])
    pipe.accum._ready = True
    pipe._initialized = True

    if "last_map_time" in d:
        pipe.last_map_time = _none_if_nan(d["last_map_time"])
    if "last_processed_t2" in d:
        pipe._last_processed_t2 = float(d["last_processed_t2"])
    if "last_prune_t" in d:
        pipe._last_prune_t = _none_if_nan(d["last_prune_t"])
    if "missing_point_times" in d:
        pipe.accum.missing_point_times = bool(d["missing_point_times"])

    if "anchors_t" in d:
        ts = np.asarray(d["anchors_t"])
        pipe._anchors = [
            AnchorRec(float(ts[i]), NavState(*(T(d["anchors_" + f][i]) for f in _NAV_FIELDS)),
                      np.asarray(d["anchors_a"][i]), np.asarray(d["anchors_w"][i]))
            for i in range(len(ts))
        ]
        # the offline re-deskew reads the dispatch-time history: seed it
        # from the restored one, as the JAX package does
        pipe._anchors_d = list(pipe._anchors)

    acc = pipe.accum
    if "acc_imu_t" in d:
        acc._imu_t = [float(t) for t in np.asarray(d["acc_imu_t"])]
        acc._imu_a = list(np.asarray(d["acc_imu_a"], np.float32))
        acc._imu_w = list(np.asarray(d["acc_imu_w"], np.float32))
        acc._imu_q = [None if np.any(np.isnan(q)) else np.asarray(q, np.float64)
                      for q in np.asarray(d["acc_imu_q"])]
    if "acc_pts" in d:
        acc._pts = [np.asarray(d["acc_pts"], np.float32)]
        acc._pts_t = [np.asarray(d["acc_pts_t"], np.float64)]
        acc._pts_i = [np.asarray(d["acc_pts_i"], np.float32) if "acc_pts_i" in d
                      else np.zeros(len(d["acc_pts"]), np.float32)]
