"""Multi-device execution: the point-sharded LIO step over torch.distributed
(port of `limovelo_tpu/parallel/sharding.py`).

One process per rank.  Every rank runs the same host runtime on the same
sensor feed; the step takes the rank's rows of the padded window (a
contiguous block of rows, as the JAX package's `P(AXIS)` cuts it: real
points come first and padding last, so the last ranks' shards are mostly
padding) and the replicated filter state and map:

- predict and the deskew path run replicated (the 23-dim filter math);
- deskew and the voxel downsample run on the local shard (per-shard dedup:
  a voxel that straddles a shard border keeps one medoid on each rank);
- the iterated update matches the local shard and all-reduces the
  Gauss-Newton normal equations HᵀH / Hᵀr (exact sums over points);
- the downsampled batch is all-gathered, so every replica of the map takes
  the identical insert.

`Mesh` stands for `jax.sharding.Mesh`: the rank, the world size, the process
group, the rank's device and the backend.  The collectives the bodies use
are its methods.  Host staging is decided once, from (backend, device),
when the mesh is built: gloo has no CUDA all-gather and no CUDA send/recv,
so with gloo on a CUDA device every collective copies its operand to the
host and back (the compute stays on the card).  NCCL refuses two ranks on
one device: ranks that share a card use gloo, nccl is for a world in which
every rank owns a card.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..deskew.compensate import build_path, compensate
from ..filter.process import predict_window
from ..filter.update import iterated_update
from ..geometry.state import select
from ..mapping.hashgrid import GridParams, HashGridMap, insert
from ..ops.voxel import voxel_downsample
from ..step import StepInputs, StepOutputs, _derive_anchor_controls, make_telemetry

AXIS = "points"


class Mesh:
    """A 1-D mesh over the ranks of a process group (the JAX package's
    `Mesh(devices, (AXIS,))`): this process's rank and device, the world
    size, the group and its backend, and the collectives over it.

    `stats` counts the collectives' calls and host seconds; with host
    staging the device-to-host copy, which waits for the stream, is outside
    the timed span, so the seconds are the exchange itself, waiting for the
    slowest rank included."""

    def __init__(self, rank: int, size: int, device, backend: str, group=None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.host_staging = backend == "gloo" and self.device.type == "cuda"
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {self.device}")
        self.stats = {"calls": 0, "seconds": 0.0}

    def describe(self) -> dict:
        return dict(rank=self.rank, size=self.size, device=str(self.device),
                    backend=self.backend, host_staging=self.host_staging)

    # -- collectives ---------------------------------------------------
    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh copy of `t` where the backend reads it."""
        return t.detach().to("cpu" if self.host_staging else self.device, copy=True)

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        buf = self._buffer(t)

        def run():
            dist.all_reduce(buf, op=op, group=self.group)
            return buf.to(t.device)

        return self._timed(run)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.psum`: the elementwise sum over ranks, on every rank."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.pmax`: the elementwise maximum over ranks."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.all_gather(..., tiled=True)`: every rank's rows of `t`,
        concatenated in rank order.  Every rank passes the same shape."""
        buf = self._buffer(t)

        def run():
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf, group=self.group)
            return torch.cat(parts).to(t.device)

        return self._timed(run)

    def _global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.ppermute` with the ring permutation i → i+1: `t` goes to
        the next rank and the previous rank's `t` comes back."""
        if self.size == 1:
            return t
        buf = self._buffer(t)

        def run():
            recv = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, buf, self._global_rank((self.rank + 1) % self.size),
                              self.group),
                   dist.P2POp(dist.irecv, recv, self._global_rank((self.rank - 1) % self.size),
                              self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return recv.to(t.device)

        return self._timed(run)

    def check_on_device(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every tensor lies on the mesh's device: a rank never
        carries on silently elsewhere."""
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"{what}: a tensor on {t.device}, the mesh's device is "
                                 f"{self.device}")


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: "cuda" without an index means
    cuda:(local rank % cards); any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        from ..device import resolve_device

        resolve_device(dev)
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def make_mesh(device="cuda") -> Mesh:
    """The mesh over the initialized default process group, on `device`
    ("cuda" by default: one card per rank, cuda:(LOCAL_RANK or rank % cards);
    "cpu" runs the plain versions)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: start the ranks with "
                           "parallel.multihost.spawn, torchrun, or init_distributed")
    rank = dist.get_rank()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank, dist.get_world_size(), dev, dist.get_backend())


def shard_rows(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous block of `n` rows (`P(AXIS)`)."""
    if n % mesh.size:
        raise ValueError(f"point bucket {n} must divide across the {mesh.size}-rank mesh")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def gather_rows(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather several row-sharded tensors (same leading length) in one
    collective: packed as float32 columns, unpacked to their dtypes.  Only
    for values a float32 holds exactly (coordinates, masks, indices below
    2²⁴)."""
    n = tensors[0].shape[0]
    cols = [t.reshape(n, -1).to(torch.float32) for t in tensors]
    full = mesh.all_gather(torch.cat(cols, dim=1))
    out, c = [], 0
    for t, col in zip(tensors, cols):
        w = col.shape[1]
        out.append(full[:, c:c + w].reshape((-1,) + tuple(t.shape[1:])).to(t.dtype))
        c += w
    return out


def _check_inputs(mesh: Mesh, inp: StepInputs, m: HashGridMap) -> None:
    mesh.check_on_device([inp.pts, inp.pts_t, inp.pts_mask, inp.P, inp.x.R, m.keys, m.pts],
                         f"rank {mesh.rank} step")


def _sharded_body(inp: StepInputs, m: HashGridMap, static_cfg, grid: GridParams,
                  mesh: Mesh) -> StepOutputs:
    """The per-rank body: `inp.pts`/`pts_t`/`pts_mask` are the rank's rows;
    state and map replicated."""
    _check_inputs(mesh, inp, m)
    # replicated sequential pieces (the 23-dim filter math)
    x_pred, P_pred = predict_window(inp.x, inp.P, inp.imus_filter, inp.t_integrated, inp.Q)
    path_mask = inp.imus_path.mask & (inp.imus_path.t > inp.anchor_t)
    imus_path = inp.imus_path._replace(mask=path_mask)
    anchor_a, anchor_w = _derive_anchor_controls(inp, path_mask)
    path = build_path(inp.anchor, inp.anchor_t, anchor_a, anchor_w, imus_path)

    # local shard: deskew and downsample (per-shard dedup)
    pts_l2 = compensate(path, inp.anchor, inp.t2, inp.pts, inp.pts_t, inp.pts_mask)
    ds = voxel_downsample(pts_l2, inp.pts_mask, inp.dyn.downsample_prec)
    total_ds = mesh.psum(ds.count)
    enough = total_ds >= inp.dyn.MAX_POINTS2MATCH

    # sharded iterated update with all-reduced normal equations
    x_corr, P_corr, diag = iterated_update(x_pred, P_pred, m, ds.pts, ds.mask, grid,
                                           static_cfg, inp.dyn, mesh=mesh)
    x_new = select(enough, x_corr, x_pred)
    P_new = torch.where(enough, P_corr, P_pred)

    # map insert: every rank's downsampled points, so all replicas take the
    # identical batch
    R_wl = x_new.R @ x_new.R_LI
    t_wl = x_new.p + x_new.R @ x_new.t_LI
    m_new = m
    if static_cfg.mapping_online:
        g_pts_all, g_mask_all = gather_rows(mesh, [ds.pts, ds.mask])
        g_ds = g_pts_all @ R_wl.T + t_wl
        m_new = insert(m, g_ds, g_mask_all & enough, grid, downsample=True)

    g_full = pts_l2 @ R_wl.T + t_wl
    g_ds_local = ds.pts @ R_wl.T + t_wl
    # ds.idx indexes the rank's rows; offset to the window index
    ds_idx_global = ds.idx + mesh.rank * inp.pts.shape[0]
    anchor_new = select(enough, x_new, inp.anchor)
    anchor_t_new = torch.where(enough, inp.t2.to(torch.float32), inp.anchor_t.to(torch.float32))
    return StepOutputs(
        x=x_new, P=P_new, map=m_new, updated=enough, ds_count=total_ds,
        global_pts=g_full, global_mask=inp.pts_mask,
        global_ds=g_ds_local, global_ds_mask=ds.mask, global_ds_idx=ds_idx_global,
        diag=diag,
        telemetry=make_telemetry(enough, total_ds, diag, x_new, m_new, anchor_t_new),
        anchor=anchor_new, anchor_t=anchor_t_new,
    )


def make_sharded_step(mesh: Mesh, config, grid: GridParams):
    """The multi-rank LIO step on `mesh`: called on every rank with the
    rank's rows of the window (`shard_rows`), the replicated state and map.
    The map's tables are written in place, as `lio_step` writes them.
    Outputs: state, map and telemetry replicated; the window fields
    (`global_*`, the planes of `diag`) the rank's rows."""
    static_cfg = config.static() if hasattr(config, "static") else config
    return partial(_sharded_body, static_cfg=static_cfg, grid=grid, mesh=mesh)
