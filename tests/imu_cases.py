"""Seeded inputs for the IMU chains (`filter/process.py::predict_window`,
`deskew/compensate.py::build_path` and `compensate`) at KITTI's scale: a
1000 Hz IMU, a car at about 8 m/s, returns out to 80 m.  Plain numpy and
torch, no JAX, so that the card's tests can use them too.

A window is (t, a, w, mask) with M entries in one of these layouts:
- "tail": the valid samples first, padding after (the pipeline's layout);
- "interleaved": a padding row after every second valid sample;
- "masked": every entry padding;
- "superset": as "tail", but the first four valid samples lie at or before
  the anchor time (the host's superset window, which lio_step masks out);
- "before": every valid sample at or before the anchor time, so lio_step's
  path holds none and takes the host's controls.
Padding rows hold junk values, which the chains must ignore.
"""

from __future__ import annotations

import numpy as np
import torch

from limovelo_tpu_torch.filter.process import ImuWindow
from limovelo_tpu_torch.geometry.state import NavState

RATE = 1000.0
LAYOUTS = ("tail", "interleaved", "masked", "superset", "before")


def _rotation(rng, scale: float) -> np.ndarray:
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def state(rng) -> NavState:
    """A moving car's state on the CPU: near the origin of the run's frame,
    heading anywhere, 8 m/s, small biases, gravity along -z, a LiDAR 0.8 m
    above the IMU turned by a few degrees.  (Near the origin as in the JAX
    parity tests: tens of metres out, a position summed over hundreds of
    samples rounds at a coarser ulp each sample, in every f32 version.)"""
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    return NavState(
        R=f(_rotation(rng, 1.5)), p=f(rng.normal(size=3) * 0.5),
        v=f(np.array([8.0, 0.0, 0.0]) + rng.normal(size=3) * 0.3),
        bg=f(rng.normal(size=3) * 0.01), ba=f(rng.normal(size=3) * 0.05),
        g=f([0.0, 0.0, -9.81]), R_LI=f(_rotation(rng, 0.05)),
        t_LI=f([0.3, -0.1, 0.8] + rng.normal(size=3) * 0.01))


def covariance(rng) -> torch.Tensor:
    """A full 23×23 SPD P with entries of 1e-6 to 1."""
    A = rng.normal(size=(23, 23)) * np.logspace(-3, 0, 23)
    return torch.as_tensor((A @ A.T / 23 + np.eye(23) * 1e-6).astype(np.float32))


def noise() -> torch.Tensor:
    """The KITTI profile's Q: gyro, acc, bias gyro, bias acc."""
    q = np.repeat([6e-4, 1.5e-2, 1e-5, 1e-4], 3)
    return torch.as_tensor(np.diag(q).astype(np.float32))


def window(rng, M: int, layout: str, t0: float = 0.0) -> ImuWindow:
    """M entries after `t0` at RATE in `layout` (module docstring); the
    last valid entry is the extrapolation to t2, 0.4 ms after the sample
    before it, as the pipeline appends it."""
    t = rng.uniform(-5, 5, M).astype(np.float32)            # junk in padding rows
    a = rng.normal(size=(M, 3)).astype(np.float32) * 50
    w = rng.normal(size=(M, 3)).astype(np.float32) * 50
    mask = np.zeros(M, bool)
    if layout == "masked":
        return ImuWindow(*(torch.as_tensor(v) for v in (t, a, w, mask)))
    if layout == "interleaved":
        rows = np.array([i for i in range(M) if i % 3 != 2])
    else:
        rows = np.arange(M - max(1, M // 5))
    n = len(rows)
    ts = t0 + (np.arange(n) + 1) / RATE
    ts[-1] = ts[-2] + 0.0004 if n > 1 else ts[-1]
    if layout == "superset":
        ts[:4] = t0 - (np.arange(4)[::-1]) / RATE                 # the last one at t0
    if layout == "before":
        ts = t0 - (np.arange(n)[::-1]) / RATE
    t[rows] = ts
    a[rows] = rng.normal(size=(n, 3)) * 0.5 + [0.2, 0.0, 9.81]
    w[rows] = rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, 0.3]
    mask[rows] = True
    return ImuWindow(*(torch.as_tensor(v) for v in (t, a, w, mask)))


def controls(rng):
    """The host's controls at the anchor: (a, w)."""
    return (torch.as_tensor((rng.normal(size=3) * 0.5 + [0.2, 0.0, 9.81]).astype(np.float32)),
            torch.as_tensor((rng.normal(size=3) * 0.2).astype(np.float32)))


def points(rng, n: int, t_lo: float, t_hi: float, node_t=None):
    """(pts, pts_t, mask): returns on a sphere shell out to 80 m, stamps in
    [t_lo, t_hi]; a tenth masked out with junk stamps, and, with `node_t`,
    a tenth stamped exactly at node times."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(2.0, 80.0, (n, 1))).astype(np.float32)
    pts[:8] = d[:8] * 80.0
    pts_t = rng.uniform(t_lo, t_hi, n).astype(np.float32)
    if node_t is not None:
        tied = rng.random(n) < 0.1
        pts_t[tied] = rng.choice(np.asarray(node_t, np.float32), int(tied.sum()))
    mask = rng.random(n) > 0.1
    pts_t[~mask] = rng.uniform(-1e3, 1e3, int((~mask).sum()))
    return tuple(torch.as_tensor(v) for v in (pts, pts_t, mask))


def to(obj, device):
    """A NamedTuple of tensors (or a tensor) on `device`, each contiguous."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device).contiguous()
    return type(obj)(*(to(v, device) for v in obj))
