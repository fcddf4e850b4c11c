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
package), so the loop needs no host round trip of its own; the host reads
the "auto" match-refresh decision (`sync.refresh`), and each eigensolve on
the card waits for the device (`sync.eigh`).  Between those reads the
update runs as sync-free stretches (`_prior` ... `_covariance`); on a card
`filter/graphs.py` replays them from CUDA graphs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import s2, so3
from ..geometry.state import ERROR_DIM, EXT_R, GRAV, ROT, NavState, boxminus, boxplus, select
from ..mapping.hashgrid import GridParams, HashGridMap, knn
from ..ops.planes import fit_planes, point_plane_distance
from ..runtime import profiling
from ..runtime.profiling import span
from .graphs import Eager, graph_key

#: blocking reads of one `torch.linalg.eigh` on a CUDA tensor: cuSOLVER's
#: syevd and the check of its info each end in a stream synchronisation
#: (counted in a CUDA trace on an H100, torch 2.11)
EIGH_READS = 2


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


def _eigh(S: torch.Tensor):
    with profiling.blocking("sync.eigh", EIGH_READS):
        return torch.linalg.eigh(S)


def _floor(lam: torch.Tensor) -> torch.Tensor:
    """A relative floor on the eigenvalues of a symmetric PSD matrix
    (rounding noise can produce tiny negatives)."""
    return torch.maximum(lam, 1e-12 * torch.amax(torch.abs(lam)))


def _floored_solve(lam: torch.Tensor, V: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """S⁻¹·rhs from the eigendecomposition (lam, V) of S."""
    lam = _floor(lam)
    return V @ ((V.T @ rhs) / lam)


def _floored_inv(lam: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """S⁻¹ from the eigendecomposition (lam, V) of S."""
    lam = _floor(lam)
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
    profiling.count("update.searches")
    with span("update.search"):
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
    with span("update.fit"):
        return fit_planes(nb, sq, nb_valid, dyn.MAX_DIST_PLANE, dyn.PLANES_THRESHOLD,
                          planarity=dyn.plane_planarity, linearity=dyn.plane_linearity)


def _gate(p_glob, fit, mask, dyn):
    """State-dependent gates and the residual, common to every match mode."""
    r = point_plane_distance(p_glob, fit)
    valid = fit.valid & mask
    if dyn.QUERY_THRESHOLD > 0.0:   # 0 = off
        valid = valid & (torch.abs(r) < dyn.QUERY_THRESHOLD)
    return r, valid


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


class _Setup(NamedTuple):
    """What every stretch of one update reads besides its values."""

    static: object        # config.StaticConfig
    dyn: object           # config.DynParams
    dtype: torch.dtype    # the window's (float32)
    solve_t: torch.dtype  # the 23×23 chain's (`StaticConfig.solve_dtype`)
    r_inv: float          # 1/LiDAR_noise
    mesh: object


# The update's sync-free stretches (see `filter/graphs.py`): each reads the
# namespace `v` and returns its new values.  Between them the host reads
# the refresh decision and runs the eigensolves and the searches.


def _prior(v, c: _Setup):
    """P⁻¹ (from P's eigendecomposition), the iterate's start at x0 and,
    for the frozen-neighbour modes, the window's range."""
    dev = v.pts.device
    out = dict(P_inv=_floored_inv(v.lam, v.V), x=v.x0,
               done=torch.zeros((), dtype=torch.bool, device=dev),
               it=torch.zeros((), dtype=torch.int32, device=dev))
    if c.static.match_mode != "rematch":
        norms = torch.linalg.vector_norm(v.pts, dim=-1)
        max_range = torch.amax(torch.where(v.mask, norms, torch.zeros_like(norms)))
        if c.mesh is not None:
            # the refresh decision precedes a search that may hold
            # collectives: reduce its one shard-local input, so every rank
            # takes the same branch
            max_range = c.mesh.pmax(max_range)
        out["max_range"] = max_range
    return out


def _refresh_bound(v, c: _Setup):
    """"auto": has the placement moved more than `match_refresh_m` since
    the last search?"""
    return dict(need=_displacement_bound(v.x, v.xs, v.max_range) > c.dyn.match_refresh_m)


def _normal_equations(v, c: _Setup):
    """Match at the iterate, weigh, and assemble the Gauss-Newton system
    S δ = rhs."""
    dyn, dtype, solve_t = c.dyn, c.dtype, c.solve_t
    if c.static.match_mode == "rematch":
        r, valid = _gate(v.p_glob, v.fit, v.mask, dyn)
    else:
        r, valid = _match_frozen(v.x, v.pts, v.nb, v.nbv, v.fit, v.mask, dyn)
    w = valid.to(dtype)
    if dyn.huber_delta > 0.0:   # robust IRLS weight; 0 = least squares
        w = w * torch.clamp(dyn.huber_delta / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
    H = observation_matrix(v.x, v.pts, v.fit.normal, c.static.estimate_extrinsics)
    Hw = H * w[:, None]
    HtH = Hw.T @ H                                     # (12,12)
    Htr = Hw.T @ (r * w)                               # (12,)
    if c.mesh is not None:                             # one all-reduce for both
        both = c.mesh.psum(torch.cat([HtH, Htr[:, None]], dim=1))
        HtH, Htr = both[:, :12], both[:, 12]

    L = chart_transport(v.x, v.x0, dtype)
    dx_prior = boxminus(v.x, v.x0)
    L_s = L.to(solve_t)
    LtPinv = L_s.T @ v.P_inv
    S = torch.zeros((ERROR_DIM, ERROR_DIM), dtype=solve_t, device=r.device)
    S[:12, :12] = HtH.to(solve_t) * c.r_inv
    S = S + LtPinv @ L_s
    g_vec = torch.zeros(ERROR_DIM, dtype=solve_t, device=r.device)
    g_vec[:12] = Htr.to(solve_t) * c.r_inv
    rhs = -(g_vec + LtPinv @ dx_prior.to(solve_t))
    return dict(r=r, valid=valid, HtH=HtH, S=S, rhs=rhs)


def _solve(v, c: _Setup):
    """δ from S's eigendecomposition."""
    return dict(delta=_floored_solve(v.lam, v.V, v.rhs).to(c.dtype))


def _advance(v, c: _Setup):
    """Degeneracy gating on the HᵀH spectrum (drop the update components
    along eigen-directions weaker than the threshold), then x ⊞ δ unless
    converged; a converged iterate is frozen."""
    delta, out = v.delta, {}
    if c.static.compute_degeneracy:
        strong = (v.eigval >= c.dyn.degeneracy_threshold).to(c.dtype)
        d12 = v.eigvec.T @ delta[:12]
        delta = torch.cat([v.eigvec @ (d12 * strong), delta[12:]])
    else:
        out["eigval"] = torch.zeros(12, dtype=c.dtype, device=delta.device)
    max_d = torch.amax(torch.abs(delta))
    out.update(x=select(v.done, v.x, boxplus(v.x, delta)), max_d=max_d,
               it=v.it + (~v.done).to(torch.int32), done=v.done | (max_d < c.dyn.LIMITS))
    return out


def _covariance_system(v, c: _Setup):
    """The information matrix at the final iterate, in its chart."""
    L_s = chart_transport(v.x, v.x0, c.dtype).to(c.solve_t)
    S = torch.zeros((ERROR_DIM, ERROR_DIM), dtype=c.solve_t, device=L_s.device)
    S[:12, :12] = v.HtH.to(c.solve_t) * c.r_inv
    return dict(S=S + L_s.T @ v.P_inv @ L_s)


def _covariance(v, c: _Setup):
    """P⁺ (symmetrised), and the match count and mean residual of the last
    iteration's match."""
    P_new = _floored_inv(v.lam, v.V)
    P_new = (0.5 * (P_new + P_new.T)).to(c.dtype)
    w = v.valid.to(c.dtype)
    n_matches = torch.sum(v.valid).to(torch.int32)
    res_sum = torch.sum(torch.abs(v.r) * w)
    if c.mesh is not None:
        # the count travels as a float32, exact below 2²⁴ matches
        both = c.mesh.psum(torch.stack([n_matches.to(c.dtype), res_sum]))
        n_matches, res_sum = both[0].to(torch.int32), both[1]
    return dict(P_new=P_new, n_matches=n_matches,
                mean_residual=res_sum / torch.clamp(n_matches, min=1))


def _eigensolve(run, S: torch.Tensor) -> None:
    lam, V = _eigh(S)
    run.put(lam=lam, V=V)


def _search_and_fit(run, x: NavState, m, grid, static_cfg, dyn, knn_fn) -> None:
    """A search at `x` for the frozen-neighbour modes: its neighbours and
    planes, and `x` as the state it ran at."""
    _, nb, sq, nbv = _search(x, m, run.v.pts, grid, static_cfg, knn_fn)
    run.put(xs=x, nb=nb, nbv=nbv, fit=_fit(nb, sq, nbv, dyn))


def iterated_update(x0: NavState, P: torch.Tensor, m: HashGridMap, pts_lidar: torch.Tensor,
                    mask: torch.Tensor, grid: GridParams, static_cfg,
                    dyn, mesh=None, knn_fn=None,
                    graphs=None) -> Tuple[NavState, torch.Tensor, UpdateDiagnostics]:
    """Run the full iterated update; returns (x⁺, P⁺, diagnostics).

    `static_cfg.match_mode`: "rematch" searches the map every iteration;
    "freeze" once at the predicted state; "auto" like freeze, but searches
    again whenever the iterate's placement moved more than
    `dyn.match_refresh_m` since the last search.

    `mesh` (the JAX package's `axis_name`): the window is this rank's shard
    and the normal equations are all-reduced.  `knn_fn` replaces the map
    query (the map-sharded step's ring KNN).

    `graphs` (`filter.graphs.UpdateGraphs`, CUDA tensors and no mesh):
    replay the sync-free stretches from CUDA graphs recorded at their first
    call for this shape and configuration; the same kernels as without."""
    if graphs is not None and mesh is not None:
        raise ValueError("the update's graphs hold no collectives: pass graphs or mesh")
    solve_t = torch.float64 if static_cfg.solve_dtype == "f64" else torch.float32
    # 1/noise in float32, as the JAX package computes it from its f32 scalar
    r_inv = float(np.float32(1.0) / np.float32(dyn.LiDAR_noise))
    c = _Setup(static_cfg, dyn, pts_lidar.dtype, solve_t, r_inv, mesh)
    run = (Eager() if graphs is None
           else graphs.stretches(graph_key(pts_lidar.shape[0], static_cfg, dyn)))
    v = run.v
    mode = static_cfg.match_mode

    run.put(x0=x0, P=P, pts=pts_lidar, mask=mask)
    _eigensolve(run, v.P.to(solve_t))
    run("prior", _prior, c)
    if mode in ("freeze", "auto"):
        _search_and_fit(run, v.x0, m, grid, static_cfg, dyn, knn_fn)

    for _ in range(static_cfg.MAX_NUM_ITERS):
        with span("update.iteration"):
            if mode == "rematch":
                p_glob, nb, sq, nbv = _search(v.x, m, v.pts, grid, static_cfg, knn_fn)
                run.put(p_glob=p_glob, fit=_fit(nb, sq, nbv, dyn))
            elif mode == "auto":
                # a host decision: the search only runs when it is needed
                run("refresh_bound", _refresh_bound, c)
                with profiling.blocking("sync.refresh"):
                    need = bool(v.need)
                if need:
                    _search_and_fit(run, v.x, m, grid, static_cfg, dyn, knn_fn)
            run("normal_equations", _normal_equations, c)
            _eigensolve(run, v.S)
            run("solve", _solve, c)
            if static_cfg.compute_degeneracy:
                eigval, eigvec = _eigh(v.HtH)
                run.put(eigval=eigval, eigvec=eigvec)
            run("advance", _advance, c)

    # the last iteration's match is the final iterate's (once done the state
    # freezes but the match still runs at it): P⁺ and the diagnostics reuse it
    with span("update.covariance"):
        run("covariance_system", _covariance_system, c)
        _eigensolve(run, v.S)
        run("covariance", _covariance, c)

    diag = UpdateDiagnostics(
        num_matches=v.n_matches,
        mean_residual=v.mean_residual,
        eigenvalues=v.eigval,
        delta_norm=v.max_d,
        iterations=v.it,
        plane_normals=v.fit.normal,
        plane_centroids=v.fit.centroid,
        plane_valid=v.valid,
    )
    return run.out((v.x, v.P_new, diag))
