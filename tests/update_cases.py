"""Iterated-update scenes built with the port alone (no JAX), for the tests
of the update's CUDA graphs (`limovelo_tpu_torch/filter/graphs.py`): a
room's surfaces in a hash-grid map, and windows of fresh samples of them
seen from near a true pose, padded to a point bucket."""

import numpy as np
import torch

from limovelo_tpu_torch.config import Config
from limovelo_tpu_torch.geometry import state as st
from limovelo_tpu_torch.mapping import hashgrid as hg

UPDATE_KW = dict(knn_rings=1, map_table_size=1 << 14, MAX_NUM_ITERS=3,
                 degeneracy_threshold=5.0, huber_delta=0.02)

#: recordings a key makes (prior, [refresh_bound,] normal_equations, solve,
#: advance, covariance_system, covariance), and replays in a window of it
#: once recorded (3 iterations), by match mode
CAPTURES = {"auto": 7, "freeze": 6, "rematch": 6}
REPLAYS = {"auto": 1 + 3 * 4 + 2, "freeze": 1 + 3 * 3 + 2, "rematch": 1 + 3 * 3 + 2}

#: the true pose the windows are seen from (the LiDAR frame is the body's)
TRUE_P = np.array([1.5, -0.5, 1.2], np.float32)


def update_config(**kw) -> Config:
    return Config(**dict(UPDATE_KW, **kw))


def room_points(rng, n, noise=0.003):
    """Points on a 12 × 10 × 3 m room's floor and walls, plus one box."""
    face = rng.integers(0, 6, n)
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    x = np.where(face == 0, -6.0, np.where(face == 1, 6.0, -6 + 12 * u))
    y = np.where(face == 2, -5.0, np.where(face == 3, 5.0, -5 + 10 * np.where(face < 2, u, v)))
    z = np.where(face == 4, 0.0, 3.0 * v)
    box = face == 5      # the top of a 2 × 2 × 1 m box
    x = np.where(box, 1 + 2 * u, x)
    y = np.where(box, -2 + 2 * v, y)
    z = np.where(box, 1.0, z)
    pts = np.stack([x, y, z], -1) + rng.normal(0, noise, (n, 3))
    return pts.astype(np.float32)


def room_map(cfg, device, n=12000, seed=7):
    """The room's map and its grid."""
    grid = hg.GridParams.from_config(cfg)
    world = torch.as_tensor(room_points(np.random.default_rng(seed), n), device=device)
    m = hg.insert(hg.make_map(grid, device=device), world,
                  torch.ones(n, dtype=torch.bool, device=device), grid)
    return m, grid


def update_window(cfg, bucket, seed, device, offset=0.06):
    """(x0, P, pts, mask): a window of fresh samples (three quarters of
    the bucket) in the LiDAR frame, padded to `bucket` rows, and a
    prediction x0 off the true pose by `offset` m in position and offset/6
    rad in rotation, in random directions.  At 0.06 m
    the "auto" refresh (0.05 m) fires; at 0.001 m it does not."""
    rng = np.random.default_rng(seed)
    n_real = (3 * bucket) // 4
    x_true = st.make_initial(cfg, device=device)._replace(
        p=torch.as_tensor(TRUE_P, device=device))
    dx = np.zeros(23, np.float32)
    for sl, size in ((slice(0, 3), offset), (slice(3, 6), offset / 6)):
        d = rng.normal(size=3)
        dx[sl] = size * d / np.linalg.norm(d)
    x0 = st.boxplus(x_true, torch.as_tensor(dx, device=device))
    pts = np.zeros((bucket, 3), np.float32)
    pts[:n_real] = room_points(rng, n_real) - TRUE_P
    mask = np.zeros(bucket, bool)
    mask[:n_real] = True
    P = st.initial_covariance(cfg, device=device) * 1e-2
    return x0, P, torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)


def assert_updates_equal(a, b):
    """Bit-for-bit equality of two `iterated_update` results: x⁺, P⁺ and
    every diagnostics field; names the first field that differs."""
    (xa, Pa, da), (xb, Pb, db) = a, b
    pairs = [(f"x.{f}", getattr(xa, f), getattr(xb, f)) for f in xa._fields]
    pairs += [("P", Pa, Pb)]
    pairs += [(f"diag.{f}", getattr(da, f), getattr(db, f)) for f in da._fields]
    for name, u, w in pairs:
        if not torch.equal(u, w):
            diff = (u.double() - w.double()).abs().max().item() if u.is_floating_point() else None
            raise AssertionError(f"{name} differs (max abs difference {diff})")
