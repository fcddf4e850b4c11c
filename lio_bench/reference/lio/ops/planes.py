"""Batched plane fitting and match validity gates (port of
`limovelo_tpu/ops/planes.py`).

Plane model: unit normal n anchored at the neighbour centroid c; the signed
distance of a point q is n·(q − c).  The normal is the smallest-eigenvalue
direction of the centred 3×3 neighbour scatter (total least squares), whose
conditioning does not depend on the distance from the origin.  The
eigenvector comes from a closed-form 3×3 symmetric eigensolver
(trigonometric roots of the characteristic cubic, then the largest cross
product of the rows of A − λI): elementwise work, no LAPACK call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class PlaneFit(NamedTuple):
    normal: torch.Tensor     # (N, 3) unit normals (zero where invalid)
    valid: torch.Tensor      # (N,)  all gates passed
    centroid: torch.Tensor   # (N, 3) neighbour centroid — the plane anchor


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _smallest_eigvec_3x3(
    A: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 3, 3) A, an
    ok-flag (False where the null-space direction is ambiguous: isotropic or
    rank-0 scatter) and the (λ_min, λ_mid, λ_max) eigenvalues."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True), min=1e-30)
    B = A / scale

    q = (B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2]) / 3.0
    Bq = B - q[..., None, None] * eye
    p2 = torch.sum(Bq * Bq, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    p_safe = torch.where(p > 1e-20, p, torch.ones_like(p))
    C = Bq / p_safe[..., None, None]
    c00, c01, c02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    c10, c11, c12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    c20, c21, c22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    detC = (c00 * (c11 * c22 - c12 * c21)
            - c01 * (c10 * c22 - c12 * c20)
            + c02 * (c10 * c21 - c11 * c20))
    r = torch.clamp(detC / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    # null-space direction of (B − λ_min I): its rows span the orthogonal plane
    M = B - lam_min[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    x01 = _cross(r0, r1)
    x12 = _cross(r1, r2)
    x02 = _cross(r0, r2)
    n01 = torch.sum(x01 * x01, dim=-1)
    n12 = torch.sum(x12 * x12, dim=-1)
    n02 = torch.sum(x02 * x02, dim=-1)
    best = torch.where(
        ((n01 >= n12) & (n01 >= n02))[..., None],
        x01,
        torch.where((n12 >= n02)[..., None], x12, x02),
    )
    nbest = torch.sqrt(torch.maximum(torch.maximum(n01, n12), n02))
    ok = (nbest > 1e-12) & (p > 1e-20)
    v = best / torch.where(nbest > 1e-12, nbest, torch.ones_like(nbest))[..., None]
    s = scale[..., 0, 0]
    return v, ok, lam_min * s, lam_mid * s, lam_max * s


def fit_planes(neighbors, sq_dists, nb_valid, max_dist_plane, planes_threshold,
               planarity=0.12, linearity=0.04) -> PlaneFit:
    """Fit a plane to each point's k neighbours (neighbors (N,k,3), sq_dists
    (N,k) ascending, nb_valid (N,k)) and apply the five gates:

    1. all k neighbours found;
    2. farthest squared distance < MAX_DIST_PLANE²;
    3. every |neighbour residual| < PLANES_THRESHOLD;
    4. λ_min ≤ planarity·λ_mid (rejects corner/edge pseudo-planes);
    5. λ_mid ≥ linearity·λ_max (rejects single scan-line stripes).
    """
    dtype = neighbors.dtype
    inf = torch.full_like(sq_dists, float("inf"))

    enough = torch.all(nb_valid, dim=-1)
    worst = torch.amax(torch.where(nb_valid, sq_dists, inf), dim=-1)
    close = worst < max_dist_plane * max_dist_plane

    w_mask = nb_valid[..., None].to(dtype)
    cnt = torch.sum(nb_valid, dim=-1).to(dtype)
    cnt_safe = torch.clamp(cnt, min=1.0)
    centroid = torch.sum(neighbors * w_mask, dim=1) / cnt_safe[..., None]
    delta = torch.where(nb_valid[..., None], neighbors - centroid[:, None, :],
                        torch.zeros_like(neighbors))
    AtA = torch.einsum("nki,nkj->nij", delta, delta)

    normal, ok, lam_min, lam_mid, lam_max = _smallest_eigvec_3x3(AtA)

    # deterministic sign: +z hemisphere (ties → +y, then +x)
    one = torch.ones_like(normal[..., 0])
    s = torch.where(
        torch.abs(normal[..., 2]) > 1e-6,
        torch.sign(normal[..., 2]),
        torch.where(
            torch.abs(normal[..., 1]) > 1e-6,
            torch.sign(normal[..., 1]),
            torch.where(normal[..., 0] >= 0, one, -one),
        ),
    )
    normal = normal * s[..., None]

    res = torch.einsum("nki,ni->nk", delta, normal)
    flat = torch.all(torch.where(nb_valid, torch.abs(res), torch.zeros_like(res))
                     < planes_threshold, dim=-1)

    planar = lam_min <= planarity * torch.clamp(lam_mid, min=1e-12)
    spread2d = lam_mid >= linearity * lam_max
    finite = torch.all(torch.isfinite(normal), dim=-1)
    valid = enough & close & flat & finite & ok & planar & spread2d
    # zero invalid rows: a later `H * mask` would still propagate NaNs
    normal = torch.where(valid[..., None], normal, torch.zeros_like(normal))
    centroid = torch.where(valid[..., None], centroid, torch.zeros_like(centroid))
    return PlaneFit(normal=normal, valid=valid, centroid=centroid)


def point_plane_distance(pts: torch.Tensor, fit: PlaneFit) -> torch.Tensor:
    """Signed distance of each (world-frame) point to its matched plane,
    taken against the centroid so no large-coordinate cancellation occurs."""
    return torch.sum((pts - fit.centroid) * fit.normal, dim=-1)
