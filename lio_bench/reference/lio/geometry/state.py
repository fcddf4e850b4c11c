"""Filter state and the 23-dim error-state chart (port of
`limovelo_tpu/geometry/state.py`).

Error-state layout:

    [ 0: 3)  pos        ℝ³
    [ 3: 6)  rot        SO(3)   (right perturbation: R ⊞ δ = R·Exp(δ))
    [ 6: 9)  extr_R     SO(3)   (LiDAR→IMU rotation offset)
    [ 9:12)  extr_t     ℝ³      (LiDAR→IMU translation offset)
    [12:15)  vel        ℝ³
    [15:18)  bg         ℝ³      gyro bias
    [18:21)  ba         ℝ³      accel bias
    [21:23)  grav       S²      (2-dim tangent, fixed ‖g‖)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import s2, se3, so3

ERROR_DIM = 23
POS, ROT, EXT_R, EXT_T, VEL, BG, BA, GRAV = 0, 3, 6, 9, 12, 15, 18, 21


class NavState(NamedTuple):
    """Nominal state — a tuple of float32 tensors on one device."""

    R: torch.Tensor       # (3,3) body→world
    p: torch.Tensor       # (3,)
    v: torch.Tensor       # (3,)
    bg: torch.Tensor      # (3,)
    ba: torch.Tensor      # (3,)
    g: torch.Tensor       # (3,)  gravity vector, ‖g‖ fixed; dynamics v̇=R(a−ba)+g
    R_LI: torch.Tensor    # (3,3) LiDAR→IMU rotation
    t_LI: torch.Tensor    # (3,)  LiDAR→IMU translation


def select(cond: torch.Tensor, a: NavState, b: NavState) -> NavState:
    """Field-wise `torch.where(cond, a, b)` for a scalar bool tensor."""
    return NavState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def make_initial(config, R0=None, dtype=torch.float32, device="cuda") -> NavState:
    """Seed state: orientation from the first IMU quaternion (R0), gravity =
    −initial_gravity, extrinsics from config."""
    kw = dict(dtype=dtype, device=device)
    R0 = torch.eye(3, **kw) if R0 is None else torch.as_tensor(np.array(R0), **kw)
    R_LI = torch.as_tensor(np.array(config.I_Rotation_L, np.float64).reshape(3, 3), **kw)
    return NavState(
        R=R0,
        p=torch.zeros(3, **kw),
        v=torch.zeros(3, **kw),
        bg=torch.zeros(3, **kw),
        ba=torch.zeros(3, **kw),
        g=torch.as_tensor(np.asarray(config.gravity_vec, np.float64), **kw),
        R_LI=R_LI,
        t_LI=torch.as_tensor(np.asarray(config.I_Translation_L, np.float64), **kw),
    )


def initial_covariance(config=None, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Initial P; the extrinsic blocks take `config.initial_cov_extrinsic_*`
    (default 1e-5, a refinement prior), scalar or per-axis for rotation."""
    diag = np.ones(ERROR_DIM, np.float64)
    rot_prior = getattr(config, "initial_cov_extrinsic_rot", 1e-5) if config else 1e-5
    diag[EXT_R:EXT_R + 3] = np.asarray(rot_prior, np.float64)
    diag[EXT_T:EXT_T + 3] = getattr(config, "initial_cov_extrinsic_trans", 1e-5) if config else 1e-5
    diag[BG:BG + 3] = 1e-4
    diag[BA:BA + 3] = 1e-3
    diag[GRAV:GRAV + 2] = 1e-5
    return torch.as_tensor(np.diag(diag), dtype=dtype, device=device)


def boxplus(x: NavState, dx: torch.Tensor) -> NavState:
    """x ⊞ dx over the compound manifold (dx: (..., 23); a leading batch
    dim broadcasts against the state)."""
    return NavState(
        R=so3.boxplus(x.R, dx[..., ROT:ROT + 3]),
        p=x.p + dx[..., POS:POS + 3],
        v=x.v + dx[..., VEL:VEL + 3],
        bg=x.bg + dx[..., BG:BG + 3],
        ba=x.ba + dx[..., BA:BA + 3],
        g=s2.boxplus(x.g, dx[..., GRAV:GRAV + 2]),
        R_LI=so3.boxplus(x.R_LI, dx[..., EXT_R:EXT_R + 3]),
        t_LI=x.t_LI + dx[..., EXT_T:EXT_T + 3],
    )


def boxminus(x1: NavState, x2: NavState) -> torch.Tensor:
    """x1 ⊟ x2 → (..., 23) error vector."""
    return torch.cat(
        [
            x1.p - x2.p,
            so3.boxminus(x1.R, x2.R),
            so3.boxminus(x1.R_LI, x2.R_LI),
            x1.t_LI - x2.t_LI,
            x1.v - x2.v,
            x1.bg - x2.bg,
            x1.ba - x2.ba,
            s2.boxminus(x1.g, x2.g),
        ],
        dim=-1,
    )


def lidar_to_imu(x: NavState) -> se3.RigidTransform:
    return se3.RigidTransform(x.R_LI, x.t_LI)


def body_to_world(x: NavState) -> se3.RigidTransform:
    return se3.RigidTransform(x.R, x.p)


def lidar_to_world(x: NavState) -> se3.RigidTransform:
    return se3.compose(body_to_world(x), lidar_to_imu(x))
