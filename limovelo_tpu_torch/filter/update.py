"""Iterated error-state measurement update, point-to-plane (port of
`limovelo_tpu/filter/update.py`).

Update math (information form of the FAST-LIO2 iterated update):

    dx_j = x_j ⊟ x0                       (error w.r.t. the predicted state)
    L_j  = ∂((x_j ⊞ δ) ⊟ x0)/∂δ |_{δ=0}   (chart transport)
    (HᵀR⁻¹H + L_jᵀP⁻¹L_j) δ = −(HᵀR⁻¹ r_j + L_jᵀP⁻¹ dx_j)
    x_{j+1} = x_j ⊞ δ ;  converged when max|δ| < LIMITS
    P⁺ = (HᵀR⁻¹H + LᵀP⁻¹L)⁻¹  at the final iterate

H rows (N×12, the remaining 11 columns zero):
    cols 0-2   ∂r/∂pos      = nᵀ
    cols 3-5   ∂r/∂rot      = (p_imu × (Rᵀn))ᵀ
    cols 6-8   ∂r/∂extr_R   = (p_lidar × (R_LIᵀ Rᵀ n))ᵀ   (if estimate_extrinsics)
    cols 9-11  ∂r/∂extr_t   = (Rᵀn)ᵀ                       (if estimate_extrinsics)

The 23×23 prior/solve chain runs in float64 on the device
(`StaticConfig.solve_dtype`); HᵀH, L and dx_prior stay float32.  Every
Gauss-Newton iteration runs (a converged iterate is frozen, as in the JAX
package), so the loop needs no host round trip; the one host read is the
"auto" match-refresh decision.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import s2, so3
from ..geometry.state import ERROR_DIM, EXT_R, GRAV, ROT, NavState, boxminus, boxplus, select
from ..mapping.hashgrid import GridParams, HashGridMap, knn
from ..ops.planes import fit_planes, point_plane_distance


class UpdateDiagnostics(NamedTuple):
    num_matches: torch.Tensor     # () int32 — valid matches at the final iteration
    mean_residual: torch.Tensor   # () mean |point-plane distance| over matches
    eigenvalues: torch.Tensor     # (12,) of HᵀH at the final iteration
    delta_norm: torch.Tensor      # () max|δ| at the final iteration
    iterations: torch.Tensor      # () int32 — GN iterations actually applied
    plane_normals: torch.Tensor   # (N,3) world-frame unit normals
    plane_centroids: torch.Tensor  # (N,3) world-frame neighbour centroids
    plane_valid: torch.Tensor     # (N,) match chosen


def observation_matrix(x: NavState, pts_lidar: torch.Tensor, normals: torch.Tensor,
                       estimate_extrinsics: bool) -> torch.Tensor:
    """Rows of H (N×12)."""
    Rt_n = normals @ x.R                                  # Rᵀ n per row
    p_imu = pts_lidar @ x.R_LI.T + x.t_LI                 # lidar → imu
    A = torch.linalg.cross(p_imu, Rt_n, dim=-1)           # ∂/∂rot
    if estimate_extrinsics:
        LiRt_n = Rt_n @ x.R_LI                            # R_LIᵀ Rᵀ n
        B = torch.linalg.cross(pts_lidar, LiRt_n, dim=-1)
        return torch.cat([normals, A, B, Rt_n], dim=-1)
    return torch.cat([normals, A, torch.zeros_like(normals).repeat(1, 2)], dim=-1)


def _eigh_spd(S: torch.Tensor):
    """Eigendecomposition of a symmetric PSD matrix with a relative floor on
    the eigenvalues (rounding noise can produce tiny negatives)."""
    lam, V = torch.linalg.eigh(S)
    lam = torch.maximum(lam, 1e-12 * torch.amax(torch.abs(lam)))
    return lam, V


def _solve_spd(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    lam, V = _eigh_spd(S)
    return V @ ((V.T @ rhs) / lam)


def _inv_spd(S: torch.Tensor) -> torch.Tensor:
    lam, V = _eigh_spd(S)
    return (V / lam[None, :]) @ V.T


def chart_transport(x: NavState, x0: NavState, dtype=torch.float32) -> torch.Tensor:
    """L = ∂((x ⊞ δ) ⊟ x0)/∂δ at δ=0, the (23,23) Jacobian transporting the
    prior chart (centred at x0, where P lives) to the chart at x.

    Each manifold component depends only on its own slice of δ, so L is
    block-diagonal: identity on the vector blocks, J_r⁻¹(Log(R0ᵀR)) on the
    two SO(3) blocks (Log(R0ᵀ·R·Exp(δ)) at δ=0) and `s2.transport` on the
    gravity block.  The JAX package gets the same blocks by forward-mode AD
    of the whole 23-dim map; here that costs thousands of small launches a
    window."""
    L = torch.eye(ERROR_DIM, dtype=dtype, device=x.p.device)
    L[ROT:ROT + 3, ROT:ROT + 3] = so3.right_jacobian_inv(so3.log(x0.R.T @ x.R))
    L[EXT_R:EXT_R + 3, EXT_R:EXT_R + 3] = so3.right_jacobian_inv(so3.log(x0.R_LI.T @ x.R_LI))
    L[GRAV:, GRAV:] = s2.transport(x.g, x0.g)
    return L


def _place_global(x: NavState, pts_lidar: torch.Tensor) -> torch.Tensor:
    """LiDAR-frame window → world frame with the current estimate."""
    return (pts_lidar @ x.R_LI.T + x.t_LI) @ x.R.T + x.p


def _search(x: NavState, m: HashGridMap, pts_lidar, grid: GridParams, static_cfg,
            knn_fn=None):
    """The KNN half of the match: place globally, query the map (through
    `knn_fn`, with `mapping.hashgrid.knn`'s signature, when given).
    Returns (p_glob, neighbors (N,k,3), sq (N,k), nb_valid (N,k))."""
    p_glob = _place_global(x, pts_lidar)
    if knn_fn is not None:
        nb, sq, nb_valid = knn_fn(m, p_glob, grid, k=static_cfg.NUM_MATCH_POINTS,
                                  rings=static_cfg.knn_rings,
                                  max_buckets=static_cfg.knn_max_buckets)
    elif static_cfg.knn_backend == "grouped":
        from ..ops.cuda.knn import knn_grouped

        nb, sq, nb_valid = knn_grouped(m, p_glob, grid, k=static_cfg.NUM_MATCH_POINTS)
    else:
        nb, sq, nb_valid = knn(m, p_glob, grid, k=static_cfg.NUM_MATCH_POINTS,
                               rings=static_cfg.knn_rings,
                               max_buckets=static_cfg.knn_max_buckets)
    return p_glob, nb, sq, nb_valid


def _fit(nb, sq, nb_valid, dyn):
    return fit_planes(nb, sq, nb_valid, dyn.MAX_DIST_PLANE, dyn.PLANES_THRESHOLD,
                      planarity=dyn.plane_planarity, linearity=dyn.plane_linearity)


def _gate(p_glob, fit, mask, dyn):
    """State-dependent gates and the residual, common to every match mode."""
    r = point_plane_distance(p_glob, fit)
    valid = fit.valid & mask
    if dyn.QUERY_THRESHOLD > 0.0:   # 0 = off
        valid = valid & (torch.abs(r) < dyn.QUERY_THRESHOLD)
    return r, valid


def _match(x, m, pts_lidar, mask, grid, static_cfg, dyn, knn_fn=None):
    """Place the window with the current estimate, KNN each point, fit
    planes, gate."""
    p_glob, nb, sq, nb_valid = _search(x, m, pts_lidar, grid, static_cfg, knn_fn)
    fit = _fit(nb, sq, nb_valid, dyn)
    r, valid = _gate(p_glob, fit, mask, dyn)
    return r, fit, valid


def _match_frozen(x: NavState, pts_lidar, nb, nb_valid, fit, mask, dyn):
    """Frozen-neighbour iteration ("freeze"/"auto"): re-place the window with
    the current iterate and re-evaluate the residuals and the state-dependent
    gates (MAX_DIST_PLANE proximity, query residual) against neighbour sets
    found earlier."""
    p_glob = _place_global(x, pts_lidar)
    d2 = torch.sum((nb - p_glob[:, None, :]) ** 2, dim=-1)
    worst = torch.amax(torch.where(nb_valid, d2, torch.full_like(d2, float("inf"))), dim=-1)
    close = worst < dyn.MAX_DIST_PLANE * dyn.MAX_DIST_PLANE
    return _gate(p_glob, fit, mask & close, dyn)


def _displacement_bound(x: NavState, xs: NavState, max_range) -> torch.Tensor:
    """Upper bound on how far any window point's global placement moved
    between iterates `xs` (where the last search ran) and `x`:
    ‖Δp‖ + ‖Δt_LI‖ + (θ(ΔR) + θ(ΔR_LI))·(max_range + ‖t_LI‖)."""
    dp = torch.linalg.vector_norm(x.p - xs.p)
    dtl = torch.linalg.vector_norm(x.t_LI - xs.t_LI)
    th = torch.linalg.vector_norm(so3.log(xs.R.T @ x.R))
    th_li = torch.linalg.vector_norm(so3.log(xs.R_LI.T @ x.R_LI))
    lever = max_range + torch.linalg.vector_norm(x.t_LI)
    return dp + dtl + (th + th_li) * lever


def iterated_update(x0: NavState, P: torch.Tensor, m: HashGridMap, pts_lidar: torch.Tensor,
                    mask: torch.Tensor, grid: GridParams, static_cfg,
                    dyn, mesh=None,
                    knn_fn=None) -> Tuple[NavState, torch.Tensor, UpdateDiagnostics]:
    """Run the full iterated update; returns (x⁺, P⁺, diagnostics).

    `static_cfg.match_mode`: "rematch" searches the map every iteration;
    "freeze" once at the predicted state; "auto" like freeze, but searches
    again whenever the iterate's placement moved more than
    `dyn.match_refresh_m` since the last search.

    `mesh` (the JAX package's `axis_name`): the window is this rank's shard
    and the normal equations are all-reduced.  `knn_fn` replaces the map
    query (the map-sharded step's ring KNN)."""
    dtype, dev = pts_lidar.dtype, pts_lidar.device
    # 1/noise in float32, as the JAX package computes it from its f32 scalar
    r_inv = float(np.float32(1.0) / np.float32(dyn.LiDAR_noise))
    solve_t = torch.float64 if static_cfg.solve_dtype == "f64" else torch.float32
    P_inv = _inv_spd(P.to(solve_t))
    mode = static_cfg.match_mode

    search_state = None
    max_range = None
    if mode in ("freeze", "auto"):
        _, nb0, sq0, nbv0 = _search(x0, m, pts_lidar, grid, static_cfg, knn_fn)
        search_state = (x0, nb0, nbv0, _fit(nb0, sq0, nbv0, dyn))
        norms = torch.linalg.vector_norm(pts_lidar, dim=-1)
        max_range = torch.amax(torch.where(mask, norms, torch.zeros_like(norms)))
        if mesh is not None:
            # the refresh decision precedes a search that may hold
            # collectives: reduce its one shard-local input, so every rank
            # takes the same branch
            max_range = mesh.pmax(max_range)

    x = x0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    out = None
    for _ in range(static_cfg.MAX_NUM_ITERS):
        if mode == "rematch":
            r, fit, valid = _match(x, m, pts_lidar, mask, grid, static_cfg, dyn, knn_fn)
        else:
            if mode == "auto":
                # a host decision: the search only runs when it is needed
                need = _displacement_bound(x, search_state[0], max_range) > dyn.match_refresh_m
                if bool(need):
                    _, nb, sq, nbv = _search(x, m, pts_lidar, grid, static_cfg, knn_fn)
                    search_state = (x, nb, nbv, _fit(nb, sq, nbv, dyn))
            _, nb, nbv, fit = search_state
            r, valid = _match_frozen(x, pts_lidar, nb, nbv, fit, mask, dyn)
        w = valid.to(dtype)
        if dyn.huber_delta > 0.0:   # robust IRLS weight; 0 = least squares
            w = w * torch.clamp(dyn.huber_delta / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
        H = observation_matrix(x, pts_lidar, fit.normal, static_cfg.estimate_extrinsics)
        Hw = H * w[:, None]
        HtH = Hw.T @ H                                     # (12,12)
        Htr = Hw.T @ (r * w)                               # (12,)
        if mesh is not None:                               # one all-reduce for both
            both = mesh.psum(torch.cat([HtH, Htr[:, None]], dim=1))
            HtH, Htr = both[:, :12], both[:, 12]

        L = chart_transport(x, x0, dtype)
        dx_prior = boxminus(x, x0)
        L_s = L.to(solve_t)
        LtPinv = L_s.T @ P_inv
        S = torch.zeros((ERROR_DIM, ERROR_DIM), dtype=solve_t, device=dev)
        S[:12, :12] = HtH.to(solve_t) * r_inv
        S = S + LtPinv @ L_s
        g_vec = torch.zeros(ERROR_DIM, dtype=solve_t, device=dev)
        g_vec[:12] = Htr.to(solve_t) * r_inv
        rhs = -(g_vec + LtPinv @ dx_prior.to(solve_t))
        delta = _solve_spd(S, rhs).to(dtype)

        # degeneracy gating on the HᵀH spectrum: drop the update components
        # along eigen-directions weaker than the threshold
        if static_cfg.compute_degeneracy:
            eigval, eigvec = torch.linalg.eigh(HtH)
            strong = (eigval >= dyn.degeneracy_threshold).to(dtype)
            d12 = eigvec.T @ delta[:12]
            delta = torch.cat([eigvec @ (d12 * strong), delta[12:]])
        else:
            eigval = torch.zeros(12, dtype=dtype, device=dev)

        x = select(done, x, boxplus(x, delta))
        max_d = torch.amax(torch.abs(delta))
        it = it + (~done).to(torch.int32)
        done = done | (max_d < dyn.LIMITS)
        # the last iteration's match is the final iterate's (once done the
        # state freezes but the match still runs at it): P⁺ and the
        # diagnostics reuse it
        out = (valid, r, eigval, max_d, HtH, fit.normal, fit.centroid)

    valid, r, eigval_last, max_d_last, HtH, normals_last, centroids_last = out
    w = valid.to(dtype)
    L_s = chart_transport(x, x0, dtype).to(solve_t)
    S = torch.zeros((ERROR_DIM, ERROR_DIM), dtype=solve_t, device=dev)
    S[:12, :12] = HtH.to(solve_t) * r_inv
    P_new = _inv_spd(S + L_s.T @ P_inv @ L_s)
    P_new = (0.5 * (P_new + P_new.T)).to(dtype)

    n_matches = torch.sum(valid).to(torch.int32)
    res_sum = torch.sum(torch.abs(r) * w)
    if mesh is not None:
        # the count travels as a float32, exact below 2²⁴ matches
        both = mesh.psum(torch.stack([n_matches.to(dtype), res_sum]))
        n_matches, res_sum = both[0].to(torch.int32), both[1]
    diag = UpdateDiagnostics(
        num_matches=n_matches,
        mean_residual=res_sum / torch.clamp(n_matches, min=1),
        eigenvalues=eigval_last,
        delta_norm=max_d_last,
        iterations=it,
        plane_normals=normals_last,
        plane_centroids=centroids_last,
        plane_valid=valid,
    )
    return x, P_new, diag
