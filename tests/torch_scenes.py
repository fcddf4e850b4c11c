"""Scenes shared by the port's replay tests: an HD map of a simulated world,
saved by the JAX package's `save_map`."""

import numpy as np
import jax.numpy as jnp

from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu.runtime.checkpoint import save_map as j_save_map


def world_cloud(world, traj, times, lines: int = 16, cols: int = 360, max_range: float = 40.0,
                frame_t: float = 0.0):
    """Points that a `lines` × `cols` ring of rays hits from the trajectory's
    poses at `times`, in the frame of the body pose at `frame_t`: the
    estimator's world frame, which starts at the body pose where the vehicle
    stands still (the simulated trajectories begin with a hold)."""
    el = np.deg2rad(np.linspace(-15, 15, lines))
    az = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    dirs = np.stack([np.cos(el)[None, :] * np.cos(az)[:, None],
                     np.cos(el)[None, :] * np.sin(az)[:, None],
                     np.broadcast_to(np.sin(el)[None, :], (cols, lines))], -1).reshape(-1, 3)
    clouds = []
    for t in times:
        R, p = traj.pose(t)
        d_w = dirs @ R.T
        r = world(np.tile(p, (len(d_w), 1)), d_w)
        ok = np.isfinite(r) & (r < max_range)
        clouds.append(p + d_w[ok] * r[ok, None])
    R0, p0 = traj.pose(frame_t)
    return ((np.concatenate(clouds) - p0) @ R0).astype(np.float32)


def save_jax_hd_map(path, cloud, table_size: int):
    """Insert `cloud` into a JAX map and save it with the JAX `save_map`."""
    grid = jhg.GridParams(table_size=table_size)
    m = jhg.insert(jhg.make_map(grid), jnp.asarray(cloud), jnp.ones(len(cloud), bool), grid)
    j_save_map(str(path), m, grid)
    return int(m.num_points)
