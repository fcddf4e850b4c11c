"""Trajectory evaluation: ATE against ground truth (the part of
`limovelo_tpu/runtime/evaluate.py` the port uses, copied: the port must not
import the JAX package)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation as Rsc


def interpolate_gt(gt_t, gt_R, gt_p, query_t):
    """Linear position + slerp rotation interpolation of ground truth."""
    query_t = np.clip(query_t, gt_t[0], gt_t[-1])
    idx = np.clip(np.searchsorted(gt_t, query_t) - 1, 0, len(gt_t) - 2)
    t0, t1 = gt_t[idx], gt_t[idx + 1]
    w = np.where(t1 > t0, (query_t - t0) / np.maximum(t1 - t0, 1e-12), 0.0)
    p = gt_p[idx] * (1 - w)[:, None] + gt_p[idx + 1] * w[:, None]
    R_out = np.empty((len(query_t), 3, 3))
    for i in range(len(query_t)):
        key = Rsc.from_matrix(np.stack([gt_R[idx[i]], gt_R[idx[i] + 1]]))
        from scipy.spatial.transform import Slerp

        R_out[i] = Slerp([0.0, 1.0], key)([w[i]]).as_matrix()[0]
    return R_out, p


def umeyama_alignment(est_p, gt_p, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment minimizing ‖gt − (sR·est + t)‖²."""
    mu_e, mu_g = est_p.mean(0), gt_p.mean(0)
    E, G = est_p - mu_e, gt_p - mu_g
    C = G.T @ E / len(est_p)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (E * E).sum() * len(est_p)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est_t, est_p, gt_t, gt_R, gt_p, align: bool = True
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE after (optional) SE(3) alignment."""
    _, gt_pi = interpolate_gt(gt_t, gt_R, gt_p, est_t)
    if align and len(est_p) >= 3:
        s, R, t = umeyama_alignment(est_p, gt_pi)
        est_p = (s * (R @ est_p.T)).T + t
    err = np.linalg.norm(est_p - gt_pi, axis=-1)
    return float(np.sqrt((err ** 2).mean())), err
