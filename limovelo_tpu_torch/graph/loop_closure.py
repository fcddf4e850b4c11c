"""Loop-closure detection and scan registration (port of
`limovelo_tpu/graph/loop_closure.py`).

Candidates are found by trajectory proximity (revisits) and verified and
measured by a point-to-plane registration of the query keyframe's scan
against a hash-grid map of the candidate's scan: the same KNN (the dense
`hashgrid.knn`, as in the JAX package), plane fit and Gauss-Newton as the
odometry update, over a 6-DoF pose instead of the 23-dim filter state.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import so3
from ..mapping.hashgrid import GridParams, insert, knn, make_map
from ..ops.planes import fit_planes, point_plane_distance


def detect_loop_candidates(
    positions: np.ndarray,       # (K,3) keyframe positions
    min_index_gap: int = 20,
    max_distance: float = 5.0,
) -> List[Tuple[int, int]]:
    """Pairs (i, j<i−gap) of keyframes that revisit the same place."""
    out = []
    for i in range(len(positions)):
        js = np.where(
            np.linalg.norm(positions[: max(i - min_index_gap, 0)] - positions[i], axis=-1)
            < max_distance
        )[0]
        if len(js):
            j = int(js[np.argmin(np.linalg.norm(positions[js] - positions[i], axis=-1))])
            out.append((i, j))
    return out


def _register(m, scan, mask, R0, p0, grid: GridParams, iters: int = 8, k: int = 5):
    """Point-to-plane ICP by Gauss-Newton over SE(3).  Returns (R, p, rms,
    matches), the last two from the final iteration's residuals."""
    R, p = R0, p0
    eye = torch.eye(6, dtype=scan.dtype, device=scan.device)
    for _ in range(iters):
        g = scan @ R.T + p
        nb, sq, nbv = knn(m, g, grid, k=k)
        fit = fit_planes(nb, sq, nbv, 2.0, 0.2)
        r = point_plane_distance(g, fit)
        w = (fit.valid & mask).to(scan.dtype)
        # H rows over [δp(3), δθ(3)], right perturbation R ← R·Exp(δθ):
        #   ∂r/∂δp = nᵀ ;  ∂r/∂δθ = (s × (Rᵀn))ᵀ
        Rt_n = fit.normal @ R
        Jrot = torch.linalg.cross(scan, Rt_n, dim=-1)
        H = torch.cat([fit.normal, Jrot], dim=-1)            # (N,6)
        Hw = H * w[:, None]
        A = Hw.T @ H + 1e-6 * eye
        b = Hw.T @ (r * w)
        delta = -torch.linalg.solve(A, b)
        n_match = torch.sum(w)
        rms = torch.sqrt(torch.sum(r * r * w) / torch.clamp(n_match, min=1.0))
        p = p + delta[:3]
        R = R @ so3.exp(delta[3:])
    return R, p, rms, n_match


def register_scan_to_map(
    scan: np.ndarray,            # (N,3) source scan, LiDAR frame
    target_pts: np.ndarray,      # (M,3) target map points, target frame
    R0: np.ndarray,
    p0: np.ndarray,
    grid: Optional[GridParams] = None,
    iters: int = 8,
    max_points: int = 4096,
    device="cuda",
):
    """Register scan → target points on `device`; returns (R, p, rms,
    n_matches).  Builds its own map of the target (a small table by
    default); a scan longer than `max_points` is subsampled with
    `default_rng(0)`, as in the JAX package, so both pick the same points."""
    dev = resolve_device(device)
    grid = grid or GridParams(table_size=1 << 13, coarse_factor=4, voxel_size=0.2)
    m = make_map(grid, device=dev)
    tp = np.asarray(target_pts, np.float32)
    for i in range(0, len(tp), 16384):
        c = tp[i:i + 16384]
        pad = np.zeros((16384, 3), np.float32)
        pad[:len(c)] = c
        msk = np.zeros(16384, bool)
        msk[:len(c)] = True
        m = insert(m, torch.as_tensor(pad, device=dev), torch.as_tensor(msk, device=dev), grid)

    s = np.asarray(scan, np.float32)
    if len(s) > max_points:
        s = s[np.random.default_rng(0).choice(len(s), max_points, replace=False)]
    pad = np.zeros((max_points, 3), np.float32)
    pad[:len(s)] = s
    msk = np.zeros(max_points, bool)
    msk[:len(s)] = True

    T = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    R, p, rms, n = _register(m, T(pad), torch.as_tensor(msk, device=dev), T(R0), T(p0), grid,
                             iters=iters)
    return R.cpu().numpy(), p.cpu().numpy(), float(rms), int(n)
