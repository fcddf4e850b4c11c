"""The core device step: one localization window, end to end (port of
`limovelo_tpu/step.py`):

    predict to t2  →  deskew (t1, t2]  →  voxel downsample  →
    iterated point-to-plane update  →  map insert (online)

and `mapping_step`, the offline mode's once-per-rotation map update.
Plain functions over fixed-shape, masked tensors on one device; the map and
filter state are explicit values threaded through.

Skip semantics match the reference:
- Map empty → the update no-ops (zero matches) and the map is built from
  this window.
- Fewer than MAX_POINTS2MATCH downsampled points → no update, no map insert,
  no anchor advance; the prediction still advances.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .deskew.compensate import build_path, compensate
from .filter.process import ImuWindow, predict_window
from .filter.update import UpdateDiagnostics, iterated_update
from .geometry import so3
from .geometry.state import NavState, select
from .mapping.hashgrid import GridParams, HashGridMap, insert
from .ops.voxel import voxel_downsample
from .runtime.profiling import span


class StepInputs(NamedTuple):
    # anchor: latest corrected state (deskew reference), its time & controls
    anchor: NavState
    anchor_t: torch.Tensor       # () rebased seconds
    anchor_a: torch.Tensor       # (3,)
    anchor_w: torch.Tensor       # (3,)
    # filter state at the last integration time
    x: NavState
    P: torch.Tensor              # (23,23)
    t_integrated: torch.Tensor   # ()
    # IMU windows (padded): the filter's covers (t_integrated, t2], the
    # path's (anchor_t, t2] — identical in steady state, distinct after skips
    imus_filter: ImuWindow
    imus_path: ImuWindow
    # raw LiDAR window (t1, t2], LiDAR frame, rebased per-point stamps
    pts: torch.Tensor            # (N,3)
    pts_t: torch.Tensor          # (N,)
    pts_mask: torch.Tensor       # (N,)
    t2: torch.Tensor             # ()
    Q: torch.Tensor              # (12,12) process noise
    dyn: object                  # config.DynParams
    # the update's recorded stretches (`filter.graphs.UpdateGraphs`, a
    # pipeline's on one card) or None: `iterated_update`'s `graphs`
    graphs: object = None


class StepOutputs(NamedTuple):
    x: NavState                  # corrected (or predicted, if skipped) @ t2
    P: torch.Tensor
    map: HashGridMap
    updated: torch.Tensor        # () bool — window had enough points
    ds_count: torch.Tensor       # () int32 downsampled-point count
    global_pts: torch.Tensor     # (N,3) deskewed window, world frame, full res
    global_mask: torch.Tensor    # (N,)
    global_ds: torch.Tensor      # (N,3) downsampled window, world frame
    global_ds_mask: torch.Tensor  # (N,)
    global_ds_idx: torch.Tensor  # (N,) original window index per ds row
    diag: UpdateDiagnostics
    telemetry: torch.Tensor      # (TELEMETRY_DIM,) f32 — what the host reads
    anchor: NavState             # deskew anchor after this step (advances on update)
    anchor_t: torch.Tensor       # () rebased seconds


#: telemetry vector layout (see make_telemetry)
TEL_UPDATED = 0
TEL_DS_COUNT = 1
TEL_MATCHES = 2
TEL_RESIDUAL = 3
TEL_ITERS = 4
TEL_R = slice(5, 14)            # row-major rotation
TEL_P = slice(14, 17)
TEL_V = slice(17, 20)
TEL_EIG = slice(20, 32)         # HᵀH eigenvalues at the final GN iteration
TEL_EXT_R = slice(32, 35)       # Log(R_LI) rotation vector
TEL_EXT_T = slice(35, 38)       # t_LI
TEL_MAP_POINTS = 38
TEL_MAP_BUCKETS = 39
TEL_MAP_DROPPED = 40            # cumulative saturation drops (hashgrid.insert)
TEL_DELTA_NORM = 41
TEL_ANCHOR_T = 42               # rebased anchor time after this step
TELEMETRY_DIM = 43


def mapping_step(m: HashGridMap, anchor: NavState, anchor_t, anchor_a, anchor_w,
                 imus_path: ImuWindow, x_t2: NavState, t2, pts, pts_t, pts_mask, dyn,
                 grid: GridParams):
    """Offline-mode map update: re-deskew the full last rotation with the
    final corrected states, downsample, insert globally.  The path is built
    from the IMU window as given (no strictly-after-anchor mask, unlike
    `lio_step`): the JAX package's semantics.  Writes the map's tables in
    place (see `mapping.hashgrid.insert`).

    Returns (map', global full-res points, global mask, global ds points,
    ds mask, ds idx)."""
    path = build_path(anchor, anchor_t, anchor_a, anchor_w, imus_path)
    pts_l2 = compensate(path, anchor, t2, pts, pts_t, pts_mask)
    R_wl = x_t2.R @ x_t2.R_LI
    t_wl = x_t2.p + x_t2.R @ x_t2.t_LI
    g_full = pts_l2 @ R_wl.T + t_wl
    ds = voxel_downsample(g_full, pts_mask, dyn.downsample_prec)
    m_new = insert(m, ds.pts, ds.mask, grid, downsample=True)
    return m_new, g_full, pts_mask, ds.pts, ds.mask, ds.idx


def make_telemetry(enough, ds_count, diag: UpdateDiagnostics, x_new: NavState,
                   m_new: HashGridMap, anchor_t, map_mesh=None) -> torch.Tensor:
    """(TELEMETRY_DIM,) f32 — the per-step record the host reads (TEL_*).

    `map_mesh`: the map is sharded over this mesh's ranks (each holds its
    own counters), so the three map counters are summed over the ranks and
    the telemetry stays replicated."""
    f32 = torch.float32

    def s(v):
        return v.to(f32).reshape(1)

    counters = torch.cat([s(m_new.num_points), s(m_new.num_buckets), s(m_new.dropped)])
    if map_mesh is not None:
        counters = map_mesh.psum(counters)
    return torch.cat([
        s(enough), s(ds_count), s(diag.num_matches), s(diag.mean_residual),
        s(diag.iterations),
        x_new.R.reshape(-1).to(f32), x_new.p.to(f32), x_new.v.to(f32),
        diag.eigenvalues.to(f32),
        so3.log(x_new.R_LI).to(f32), x_new.t_LI.to(f32),
        counters, s(diag.delta_norm), s(anchor_t),
    ])


def lio_step(inp: StepInputs, m: HashGridMap, static_cfg, grid: GridParams) -> StepOutputs:
    """One window.  The map's point tables are updated in place (see
    `mapping.hashgrid.insert`): pass the returned map to the next step."""
    # ---- IMU propagation ----
    with span("step.predict"):
        x_pred, P_pred = predict_window(inp.x, inp.P, inp.imus_filter, inp.t_integrated, inp.Q)

    # ---- motion deskew ----
    with span("step.deskew"):
        path = build_path(inp.anchor, inp.anchor_t, inp.anchor_a, inp.anchor_w, inp.imus_path,
                          after_anchor=True)
        pts_l2 = compensate(path, inp.anchor, inp.t2, inp.pts, inp.pts_t, inp.pts_mask)

    # ---- spatial downsample ----
    with span("step.voxel"):
        ds = voxel_downsample(pts_l2, inp.pts_mask, inp.dyn.downsample_prec)
        enough = ds.count >= inp.dyn.MAX_POINTS2MATCH

    # ---- iterated point-to-plane update ----
    with span("step.update"):
        x_corr, P_corr, diag = iterated_update(x_pred, P_pred, m, ds.pts, ds.mask, grid,
                                               static_cfg, inp.dyn, graphs=inp.graphs)
        x_new = select(enough, x_corr, x_pred)
        P_new = torch.where(enough, P_corr, P_pred)

    # ---- mapping (online) ----
    with span("step.insert"):
        R_wl = x_new.R @ x_new.R_LI
        t_wl = x_new.p + x_new.R @ x_new.t_LI
        g_ds = ds.pts @ R_wl.T + t_wl
        m_new = m
        if static_cfg.mapping_online:
            m_new = insert(m, g_ds, ds.mask & enough, grid, downsample=True)

    g_full = pts_l2 @ R_wl.T + t_wl

    # anchor threading: the corrected state when the window updated
    anchor_new = select(enough, x_new, inp.anchor)
    anchor_t_new = torch.where(enough, inp.t2.to(torch.float32), inp.anchor_t.to(torch.float32))

    with span("step.telemetry"):
        telemetry = make_telemetry(enough, ds.count, diag, x_new, m_new, anchor_t_new)
    return StepOutputs(
        x=x_new, P=P_new, map=m_new, updated=enough, ds_count=ds.count,
        global_pts=g_full, global_mask=inp.pts_mask,
        global_ds=g_ds, global_ds_mask=ds.mask, global_ds_idx=ds.idx,
        diag=diag, telemetry=telemetry, anchor=anchor_new, anchor_t=anchor_t_new,
    )
