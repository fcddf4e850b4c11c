"""SO(3) operations (port of `limovelo_tpu/geometry/so3.py`).

Rotations are 3×3 matrices in the tensor's trailing two dims; every function
broadcasts over leading dims.  Taylor fallbacks near θ→0 keep the values
finite.
"""

from __future__ import annotations

import torch


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of hat(w) via Rodrigues, Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    small = theta < 1e-4
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def _to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → quaternion (w, x, y, z): of the four closed forms,
    take the one whose pivot (4w², 4x², 4y² or 4z²) is largest, which is
    stable at every angle, π included."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22   # 4w²
    tx = 1.0 + m00 - m11 - m22   # 4x²
    ty = 1.0 - m00 + m11 - m22   # 4y²
    tz = 1.0 - m00 - m11 + m22   # 4z²

    sw = torch.sqrt(torch.clamp(tw, min=1e-12))
    qw = torch.stack([sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = torch.sqrt(torch.clamp(tx, min=1e-12))
    qx = torch.stack([(m21 - m12) / sx, sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = torch.sqrt(torch.clamp(ty, min=1e-12))
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy, (m12 + m21) / sy], dim=-1)
    sz = torch.sqrt(torch.clamp(tz, min=1e-12))
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz], dim=-1)

    cases = torch.stack([qw, qx, qy, qz], dim=-2)                 # (...,4,4)
    which = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    idx = which[..., None, None].expand(*which.shape, 1, 4)
    q = torch.gather(cases, -2, idx)[..., 0, :] * 0.5
    # canonicalize w ≥ 0
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation-matrix logarithm → axis-angle; stable at 0 and π (via quat)."""
    q = _to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    nv = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(nv, w)
    small = nv < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6),
                        angle / torch.where(small, torch.ones_like(nv), nv))
    return v * scale[..., None]


def right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """J_r⁻¹(w), so that Log(Exp(w)·Exp(δ)) ≈ w + J_r⁻¹(w)·δ:
    I + ½·hat(w) + (1 − (θ/2)·cot(θ/2))/θ² · hat(w)², Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    half = 0.5 * theta
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
                    / torch.where(small, one, theta2))
    return _eye_like(W) + 0.5 * W + c[..., None, None] * (W @ W)


def boxplus(R: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """R ⊞ dw = R · Exp(dw) (right perturbation)."""
    return R @ exp(dw)


def boxminus(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """R1 ⊟ R2 = Log(R2ᵀ R1), the right-perturbation error."""
    return log(R2.transpose(-1, -2) @ R1)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(w), so that Exp(w + δ) ≈ Exp(J_l(w)·δ)·Exp(w):
    I + (1 − cos θ)/θ² · hat(w) + (θ − sin θ)/θ³ · hat(w)², Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, one, theta2 * theta))
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """J_l⁻¹(w) = I − ½·hat(w) + (1 − (θ/2)·cot(θ/2))/θ² · hat(w)², Taylor-safe
    at 0 (J_l⁻¹(w) = J_r⁻¹(−w))."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    half = theta * 0.5
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
                    / torch.where(small, one, theta2))
    return _eye_like(W) - 0.5 * W + c[..., None, None] * (W @ W)


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation matrix back onto SO(3): two Newton steps of
    R ← R·(3I − RᵀR)/2 (no SVD)."""
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * _eye_like(RtR) - 0.5 * RtR)
    return R
