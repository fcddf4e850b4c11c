"""Rigid transforms (R, t) — port of `limovelo_tpu/geometry/se3.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RigidTransform(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def identity(dtype=torch.float32, device="cuda") -> RigidTransform:
    return RigidTransform(torch.eye(3, dtype=dtype, device=device),
                          torch.zeros(3, dtype=dtype, device=device))


def compose(a: RigidTransform, b: RigidTransform) -> RigidTransform:
    """a * b (apply b first)."""
    return RigidTransform(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def inverse(a: RigidTransform) -> RigidTransform:
    """(Rᵀ, −Rᵀ t)."""
    Rt = a.R.transpose(-1, -2)
    return RigidTransform(Rt, -(Rt @ a.t[..., None])[..., 0])


def apply(a: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., N, 3) or (..., 3) by a."""
    if pts.dim() == a.R.dim() - 1:  # single point per transform
        return (a.R @ pts[..., None])[..., 0] + a.t
    return pts @ a.R.transpose(-1, -2) + a.t[..., None, :]
