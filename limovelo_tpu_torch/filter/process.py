"""IMU process model and covariance propagation (port of
`limovelo_tpu/filter/process.py`).

Continuous dynamics (right-perturbation error state, noise order
(ng, na, nbg, nba)):

    ṗ = v            Ṙ = R·hat(w−bg)         v̇ = R(a−ba) + g
    ḃg = nbg         ḃa = nba                ġ = 0   (S², ‖g‖ fixed)

`predict_window` replays a padded IMU window: on a CUDA tensor in one
launch of the kernel in `csrc/imu_chain.cu` (`ops/cuda/imu_chain.py`), on a
CPU tensor by `predict_window_plain`.  There everything that does not
depend on the running state (the per-sample dt, the rotation increments,
the noise products) is computed for the whole window at once; only the
3×3 rotation chain and the 23×23 covariance chain stay sequential.  Masked
entries have dt = 0, which makes them exact identity updates.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import s2, so3
from ..geometry.state import BA, BG, ERROR_DIM, GRAV, NavState, POS, ROT, VEL
from ..ops.cuda import imu_chain

NOISE_DIM = 12  # (gyro, acc, bias-gyro, bias-acc)


class ImuWindow(NamedTuple):
    """Padded IMU batch covering (last_integrated, t2]; newest last.

    Sample i advances the state from t[i-1] (or t0 for i=0) to t[i] with
    controls (a[i], w[i]).  The final entry replays the last IMU
    extrapolated to t2."""

    t: torch.Tensor      # (M,)
    a: torch.Tensor      # (M, 3)
    w: torch.Tensor      # (M, 3)
    mask: torch.Tensor   # (M,) bool — False entries are padding (dt forced 0)


def process_noise_Q(config, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """12×12 block-diagonal Q."""
    q = np.concatenate(
        [
            np.full(3, config.covariance_gyroscope),
            np.full(3, config.covariance_acceleration),
            np.full(3, config.covariance_bias_gyroscope),
            np.full(3, config.covariance_bias_acceleration),
        ]
    )
    return torch.as_tensor(np.diag(q), dtype=dtype, device=device)


def nominal_step(x: NavState, a, w, dt) -> NavState:
    """x ⊞ f(x,u)·dt — exact Exp for rotation, Euler elsewhere."""
    acc_w = (x.R @ (a - x.ba)) + x.g
    return x._replace(
        R=x.R @ so3.exp((w - x.bg) * dt),
        p=x.p + x.v * dt + 0.5 * acc_w * dt * dt,
        v=x.v + acc_w * dt,
    )


def error_jacobians(x: NavState, a, w, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discrete error-state Jacobians (Fx: 23×23, Fw: 23×12), first order.

    Batched: `x.R`, `a`, `w` and `dt` may carry a leading sample dim (M);
    the returned Jacobians then have shape (M, 23, 23) and (M, 23, 12)."""
    dt = torch.as_tensor(dt, dtype=x.p.dtype, device=x.p.device)
    batch = dt.shape
    kw = dict(dtype=x.p.dtype, device=x.p.device)
    I3 = torch.eye(3, **kw)
    d = dt[..., None, None]
    R = x.R.expand(*batch, 3, 3)

    Fx = torch.eye(ERROR_DIM, **kw).repeat(*batch, 1, 1)
    Fx[..., ROT:ROT + 3, ROT:ROT + 3] = so3.exp(-(w - x.bg) * dt[..., None])
    Fx[..., ROT:ROT + 3, BG:BG + 3] = -I3 * d
    Fx[..., VEL:VEL + 3, ROT:ROT + 3] = -(R @ so3.hat(a - x.ba)) * d
    Fx[..., VEL:VEL + 3, BA:BA + 3] = -R * d
    Fx[..., VEL:VEL + 3, GRAV:GRAV + 2] = s2.dexp_dg(x.g) * d
    Fx[..., POS:POS + 3, VEL:VEL + 3] = I3 * d

    Fw = torch.zeros(*batch, ERROR_DIM, NOISE_DIM, **kw)
    Fw[..., ROT:ROT + 3, 0:3] = -I3 * d       # gyro noise → rotation
    Fw[..., VEL:VEL + 3, 3:6] = -R * d        # accel noise → velocity
    Fw[..., BG:BG + 3, 6:9] = I3 * d          # bias random walks
    Fw[..., BA:BA + 3, 9:12] = I3 * d
    return Fx, Fw


def masked_dt(t: torch.Tensor, mask: torch.Tensor, t0) -> torch.Tensor:
    """dt of each entry against the last VALID entry before it (or t0):
    max(t[i] − t_prev, 0) where valid, else 0."""
    M = t.shape[0]
    t0 = torch.as_tensor(t0, dtype=t.dtype, device=t.device).reshape(1)
    idx = torch.where(mask, torch.arange(1, M + 1, device=t.device), 0)
    # index into [t0, t...] of the last valid entry at or before each i
    last = torch.cummax(idx, dim=0).values
    prev = torch.cat([torch.zeros(1, dtype=last.dtype, device=t.device), last[:-1]])
    t_prev = torch.cat([t0, t])[prev]
    return torch.where(mask, torch.clamp(t - t_prev, min=0.0), torch.zeros_like(t))


def rotation_chain(R0: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """(M+1, 3, 3): R0, R0·inc[0], R0·inc[0]·inc[1], …"""
    Rs = [R0]
    for i in range(inc.shape[0]):
        Rs.append(Rs[-1] @ inc[i])
    return torch.stack(Rs)


def predict_window(x: NavState, P: torch.Tensor, imus: ImuWindow, t0, Q: torch.Tensor):
    """Propagate (x, P) through every IMU sample in the window, including the
    final extrapolation entry to t2 (the caller appends it): the CUDA kernel
    for CUDA tensors, `predict_window_plain` otherwise.

    Returns (x_t2, P_t2)."""
    if P.device.type == "cuda":
        R, p, v, P_t2 = imu_chain.predict(x, P, imus, t0, Q)
        return x._replace(R=R, p=p, v=v), P_t2
    return predict_window_plain(x, P, imus, t0, Q)


def predict_window_plain(x: NavState, P: torch.Tensor, imus: ImuWindow, t0, Q: torch.Tensor):
    """`predict_window` in plain PyTorch, on whatever device the tensors
    are (the kernel's reference)."""
    dt = masked_dt(imus.t, imus.mask, t0)                       # (M,)
    Rs = rotation_chain(x.R, so3.exp((imus.w - x.bg) * dt[:, None]))
    R_prev = Rs[:-1]                                            # state before each sample
    acc_w = (R_prev @ (imus.a - x.ba)[..., None])[..., 0] + x.g  # (M,3)
    # p and v are running sums of per-sample increments
    d = dt[:, None]
    vs = torch.cumsum(torch.cat([x.v[None], acc_w * d]), dim=0)  # (M+1,3)
    dp = vs[:-1] * d + 0.5 * acc_w * d * d
    p = torch.cumsum(torch.cat([x.p[None], dp]), dim=0)[-1]
    v = vs[-1]

    Fx, Fw = error_jacobians(x._replace(R=R_prev), imus.a, imus.w, dt)
    FwQFw = Fw @ Q @ Fw.transpose(-1, -2)                       # (M,23,23)
    for i in range(dt.shape[0]):
        P = Fx[i] @ P @ Fx[i].T + FwQFw[i]
    return x._replace(R=Rs[-1], p=p, v=v), P
