"""The comparison that decides `correct`: the program's state after every
window it processed, and the pose each of its records reports, against the
reference's after the same window.

Each number is the largest gap over the windows the two share (pose,
velocity, extrinsics, covariance, map and downsample counters), plus the
count of windows that only one side processed or updated, which must be 0.
A run is correct when no window failed and every number is within its limit
(`limits/<cell>.json`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

class Outputs(NamedTuple):
    """One side's results, on the host."""

    t2: np.ndarray          # (n,) end of each processed window
    R: np.ndarray           # (n,3,3)
    p: np.ndarray           # (n,3)
    v: np.ndarray           # (n,3)
    R_LI: np.ndarray        # (n,3,3)
    t_LI: np.ndarray        # (n,3)
    P: np.ndarray           # (n,23,23)
    rec_t: np.ndarray       # (m,) windows that updated: their records
    rec_R: np.ndarray       # (m,3,3) the pose each record reports
    rec_p: np.ndarray       # (m,3)
    map_points: np.ndarray  # (m,)
    ds_count: np.ndarray    # (m,)


def collect(windows: List[Tuple[float, object, torch.Tensor]], records) -> Outputs:
    """`windows`: (t2, state, P) after each processed window, device tensors
    (read here, after the measured window); `records`: the updated windows'
    records."""
    def stack(get, shape):
        if not windows:
            return np.zeros((0, *shape))
        return torch.stack([get(w).to(torch.float64) for w in windows]).cpu().numpy()

    return Outputs(
        t2=np.array([w[0] for w in windows], np.float64),
        R=stack(lambda w: w[1].R, (3, 3)),
        p=stack(lambda w: w[1].p, (3,)),
        v=stack(lambda w: w[1].v, (3,)),
        R_LI=stack(lambda w: w[1].R_LI, (3, 3)),
        t_LI=stack(lambda w: w[1].t_LI, (3,)),
        P=stack(lambda w: w[2], (23, 23)),
        rec_t=np.array([r.t for r in records], np.float64),
        rec_R=np.array([r.R for r in records], np.float64).reshape(-1, 3, 3),
        rec_p=np.array([r.p for r in records], np.float64).reshape(-1, 3),
        map_points=np.array([r.map_points for r in records], np.float64),
        ds_count=np.array([r.ds_count for r in records], np.float64),
    )


def finite_windows(out: Outputs) -> np.ndarray:
    """(n,) True where the state after the window is finite."""
    ok = np.ones(len(out.t2), bool)
    for a in (out.R, out.p, out.v, out.R_LI, out.t_LI, out.P):
        ok &= np.isfinite(a.reshape(len(out.t2), -1)).all(axis=1)
    return ok


def _angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle of Raᵀ Rb (stable for small angles: ‖Ra − Rb‖_F = 2√2 sin(θ/2))."""
    fro = np.linalg.norm((Ra - Rb).reshape(len(Ra), -1), axis=1)
    return np.rad2deg(2.0 * np.arcsin(np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def _worst(x: np.ndarray) -> float:
    if len(x) == 0:
        return 0.0
    x = np.where(np.isfinite(x), x, np.inf)
    return float(np.max(x))


def gaps(prog: Outputs, ref: Outputs, estimate_extrinsics: bool) -> Dict[str, float]:
    """The numbers compared, worst over the windows both sides processed."""
    ip = {t: i for i, t in enumerate(prog.t2)}
    ir = {t: i for i, t in enumerate(ref.t2)}
    common = [t for t in ref.t2 if t in ip]
    a = np.array([ip[t] for t in common], int)
    b = np.array([ir[t] for t in common], int)
    rp = {t: i for i, t in enumerate(prog.rec_t)}
    rr = {t: i for i, t in enumerate(ref.rec_t)}
    rc = [t for t in ref.rec_t if t in rp]
    ra = np.array([rp[t] for t in rc], int)
    rb = np.array([rr[t] for t in rc], int)

    mismatch = len(set(ip) ^ set(ir)) + len(set(rp) ^ set(rr))
    if not common:
        mismatch = max(mismatch, 1)
    P_ref = ref.P[b]
    fro_ref = np.maximum(np.linalg.norm(P_ref.reshape(len(b), -1), axis=1), 1e-30)
    out = {
        "windows_mismatch": float(mismatch),
        "pos_gap_m": max(_worst(np.linalg.norm(prog.p[a] - ref.p[b], axis=1)),
                         _worst(np.linalg.norm(prog.rec_p[ra] - ref.rec_p[rb], axis=1))),
        "rot_gap_deg": max(_worst(_angle_deg(prog.R[a], ref.R[b])),
                           _worst(_angle_deg(prog.rec_R[ra], ref.rec_R[rb]))),
        "vel_gap_mps": _worst(np.linalg.norm(prog.v[a] - ref.v[b], axis=1)),
        "cov_gap": _worst(np.linalg.norm((prog.P[a] - P_ref).reshape(len(b), -1), axis=1)
                          / fro_ref),
        "map_gap": _worst(np.abs(prog.map_points[ra] - ref.map_points[rb])
                          / np.maximum(ref.map_points[rb], 1.0)),
        "ds_gap": _worst(np.abs(prog.ds_count[ra] - ref.ds_count[rb])
                         / np.maximum(ref.ds_count[rb], 1.0)),
    }
    if estimate_extrinsics:
        out["extr_gap_m"] = _worst(np.linalg.norm(prog.t_LI[a] - ref.t_LI[b], axis=1))
        out["extr_rot_gap_deg"] = _worst(_angle_deg(prog.R_LI[a], ref.R_LI[b]))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float], failed: int
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number without one is reported with limit None and decides
    nothing."""
    checks, ok = {}, failed == 0
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    checks["failed_windows"] = {"value": float(failed), "limit": 0.0}
    return ok, checks
