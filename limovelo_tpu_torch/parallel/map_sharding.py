"""Map-block sharding: the hash-grid map partitioned over the ranks (port of
`limovelo_tpu/parallel/map_sharding.py`).

- **Ownership**: a coarse bucket key `c` belongs to rank
  `owner_of(c) = hash2(c) mod D`, with primes distinct from the in-table
  probe hash, so table slot and owner are independent.  Each rank stores
  only its buckets, in a local `HashGridMap` of `table_size / D` rows: the
  lookup, insert and prune code runs unchanged on the local shard.
- **Insert**: the (downsampled, small) insert batch is all-gathered and each
  rank inserts the rows it owns: every key lands on exactly one rank.
- **KNN** (`ring_knn`): query blocks circulate the ring.  At each of D hops a
  rank matches the visiting block against its local shard with the dense
  `knn`, folds the result into the block's running top-k, and passes the
  block on (`Mesh.ring_shift`).  After D hops every block has seen every
  shard and is home again; ownership partitions the candidate set, so the
  result is the unsharded query's.  The grouped kernel is not on this path,
  as the Pallas kernel is not on the JAX package's.

Map sharding buys capacity (D× the buckets), not matcher work: each rank
still evaluates N queries over the D hops.
"""

from __future__ import annotations

from functools import partial

import torch

from ..deskew.compensate import build_path, compensate
from ..filter.process import predict_window
from ..filter.update import iterated_update
from ..geometry.state import select
from ..mapping.hashgrid import (GridParams, HashGridMap, _fine_coords, insert, knn, make_map,
                                prune)
from ..ops.voxel import voxel_downsample
from ..step import StepInputs, StepOutputs, _derive_anchor_controls, make_telemetry
from .sharding import AXIS, Mesh, _check_inputs, gather_rows

__all__ = ["AXIS", "local_grid", "owner_of", "insert_sharded", "ring_knn", "prune_sharded",
           "make_sharded_map", "make_map_sharded_step", "gather_map"]

# distinct from hashgrid._PRIMES so owner and table slot are uncorrelated
_OWNER_PRIMES = (2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF


def _mul32(c: torch.Tensor, prime: int) -> torch.Tensor:
    """(c · prime) mod 2³² for c in [0, 2³²), in int64 without overflow: the
    product of two 32-bit values does not fit an int64, so it is taken as
    two 48-bit partial products."""
    lo = c * (prime & 0xFFFF)
    hi = ((c * (prime >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def local_grid(grid: GridParams, n_ranks: int) -> GridParams:
    """Per-rank table geometry: the table rows split D ways."""
    if grid.table_size % n_ranks:
        raise ValueError(f"table_size {grid.table_size} must divide by the mesh size {n_ranks}")
    return grid._replace(table_size=grid.table_size // n_ranks)


def owner_of(coarse: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """Rank owning a coarse bucket coordinate (..., 3) → int32 in [0, D): the
    JAX package's uint32 hash, in int64 with every product masked to 32
    bits (as `hashgrid._hash_coords` computes its own)."""
    c = coarse.to(torch.int64) & _U32
    h = (_mul32(c[..., 0], _OWNER_PRIMES[0]) ^ _mul32(c[..., 1], _OWNER_PRIMES[1])
         ^ _mul32(c[..., 2], _OWNER_PRIMES[2]))
    return (h % n_ranks).to(torch.int32)


def _coarse_of_pts(pts: torch.Tensor, grid: GridParams) -> torch.Tensor:
    fine = _fine_coords(pts, grid.voxel_size)
    return torch.div(fine, grid.coarse_factor, rounding_mode="floor")


def insert_sharded(m_local: HashGridMap, pts: torch.Tensor, mask: torch.Tensor,
                   lgrid: GridParams, mesh: Mesh, downsample: bool = True) -> HashGridMap:
    """Insert a row-sharded batch into the sharded map (every rank calls
    it): the batch is gathered, and each rank takes the rows whose bucket it
    owns.  Writes the local tables in place, as `insert` does."""
    pts_all, mask_all = gather_rows(mesh, [pts, mask])
    mine = owner_of(_coarse_of_pts(pts_all, lgrid), mesh.size) == mesh.rank
    return insert(m_local, pts_all, mask_all & mine, lgrid, downsample=downsample)


def ring_knn(m_local: HashGridMap, queries: torch.Tensor, lgrid: GridParams, mesh: Mesh,
             k: int = 5, rings: int = 1, max_buckets=None):
    """KNN against the union of all map shards (every rank calls it).

    `queries` is this rank's (n, 3) block.  Returns (neighbors (n,k,3),
    sq_dists (n,k) ascending, valid (n,k)) for the home block: the unsharded
    `knn`'s result, since ownership partitions the candidates and a top-k
    merges associatively."""
    n = queries.shape[0]
    q = queries
    b_pts = torch.zeros((n, k, 3), dtype=queries.dtype, device=queries.device)
    b_d2 = torch.full((n, k), float("inf"), dtype=queries.dtype, device=queries.device)
    for _ in range(mesh.size):
        nb, sq, _ = knn(m_local, q, lgrid, k=k, rings=rings, max_buckets=max_buckets)
        # fold the visiting block's candidates into its running top-k; ties
        # keep the earlier entry (`lax.top_k`'s order)
        cat_d2 = torch.cat([b_d2, sq], dim=1)                    # (n, 2k)
        cat_pts = torch.cat([b_pts, nb], dim=1)                  # (n, 2k, 3)
        order = torch.sort(cat_d2, dim=1, stable=True).indices[:, :k]
        b_d2 = torch.gather(cat_d2, 1, order)
        b_pts = torch.gather(cat_pts, 1, order[..., None].expand(n, k, 3))
        # the block and its running result travel on together
        packed = mesh.ring_shift(torch.cat([q, b_pts.reshape(n, 3 * k), b_d2], dim=1))
        q, b_d2 = packed[:, :3], packed[:, 3 + 3 * k:]
        b_pts = packed[:, 3:3 + 3 * k].reshape(n, k, 3)
    valid = torch.isfinite(b_d2)
    return b_pts, torch.where(valid, b_d2, torch.full_like(b_d2, float("inf"))), valid


def prune_sharded(m_local: HashGridMap, center: torch.Tensor, radius: float, lgrid: GridParams,
                  mesh: Mesh) -> HashGridMap:
    """`hashgrid.prune` on the sharded map, as the JAX package runs it: its
    pipeline prunes the global (D·T/D-row) arrays in one pass, so the
    points and buckets dropped on ALL ranks are subtracted from EVERY rank's
    counters (shape (D,) there), and the summed telemetry counters fall D
    times the pruned amount (ROADMAP, "Faults to reproduce").  The tables
    are pruned correctly."""
    before = torch.stack([m_local.num_points, m_local.num_buckets])
    m = prune(m_local, center, radius, lgrid)
    dropped = mesh.psum(before - torch.stack([m.num_points, m.num_buckets]))
    return m._replace(num_points=before[0] - dropped[0], num_buckets=before[1] - dropped[1])


def make_sharded_map(mesh: Mesh, grid: GridParams) -> HashGridMap:
    """The rank's empty shard of the map: `table_size / D` rows on the
    mesh's device, scalar counters (the JAX package's (D,) counters, one per
    rank)."""
    return make_map(local_grid(grid, mesh.size), device=mesh.device)


def _body(inp: StepInputs, m_local: HashGridMap, static_cfg, lgrid: GridParams,
          mesh: Mesh) -> StepOutputs:
    """The per-rank body: points sharded, the map's table rows sharded, the
    filter state replicated.  `sharding._sharded_body` with the ring KNN and
    the owner-routed insert."""
    _check_inputs(mesh, inp, m_local)
    x_pred, P_pred = predict_window(inp.x, inp.P, inp.imus_filter, inp.t_integrated, inp.Q)
    path_mask = inp.imus_path.mask & (inp.imus_path.t > inp.anchor_t)
    imus_path = inp.imus_path._replace(mask=path_mask)
    anchor_a, anchor_w = _derive_anchor_controls(inp, path_mask)
    path = build_path(inp.anchor, inp.anchor_t, anchor_a, anchor_w, imus_path)

    pts_l2 = compensate(path, inp.anchor, inp.t2, inp.pts, inp.pts_t, inp.pts_mask)
    ds = voxel_downsample(pts_l2, inp.pts_mask, inp.dyn.downsample_prec)
    total_ds = mesh.psum(ds.count)
    enough = total_ds >= inp.dyn.MAX_POINTS2MATCH

    x_corr, P_corr, diag = iterated_update(
        x_pred, P_pred, m_local, ds.pts, ds.mask, lgrid, static_cfg, inp.dyn, mesh=mesh,
        knn_fn=partial(ring_knn, mesh=mesh))
    x_new = select(enough, x_corr, x_pred)
    P_new = torch.where(enough, P_corr, P_pred)

    R_wl = x_new.R @ x_new.R_LI
    t_wl = x_new.p + x_new.R @ x_new.t_LI
    g_ds = ds.pts @ R_wl.T + t_wl
    m_new = m_local
    if static_cfg.mapping_online:
        m_new = insert_sharded(m_local, g_ds, ds.mask & enough, lgrid, mesh, downsample=True)

    g_full = pts_l2 @ R_wl.T + t_wl
    anchor_new = select(enough, x_new, inp.anchor)
    anchor_t_new = torch.where(enough, inp.t2.to(torch.float32), inp.anchor_t.to(torch.float32))
    # local window index → window index (see sharding._sharded_body)
    ds_idx_global = ds.idx + mesh.rank * inp.pts.shape[0]
    return StepOutputs(
        x=x_new, P=P_new, map=m_new, updated=enough, ds_count=total_ds,
        global_pts=g_full, global_mask=inp.pts_mask,
        global_ds=g_ds, global_ds_mask=ds.mask, global_ds_idx=ds_idx_global,
        diag=diag,
        telemetry=make_telemetry(enough, total_ds, diag, x_new, m_new, anchor_t_new,
                                 map_mesh=mesh),
        anchor=anchor_new, anchor_t=anchor_t_new,
    )


def make_map_sharded_step(mesh: Mesh, config, grid: GridParams):
    """The LIO step with both point and map sharding on `mesh`: called on
    every rank with the rank's rows of the window and its map shard
    (`make_sharded_map`); the filter state replicated.  Telemetry carries
    the map counters summed over the ranks."""
    static_cfg = config.static() if hasattr(config, "static") else config
    return partial(_body, static_cfg=static_cfg, lgrid=local_grid(grid, mesh.size), mesh=mesh)


def gather_map(m_local: HashGridMap, mesh: Mesh) -> HashGridMap:
    """Every rank's shard joined into one map in the JAX package's global
    layout: the table rows of rank 0, then rank 1, ...; counters of shape
    (D,).  A collective: every rank calls it and receives the whole map."""
    counters = mesh.all_gather(torch.stack([m_local.num_points, m_local.num_buckets,
                                            m_local.dropped])[None])
    return HashGridMap(keys=mesh.all_gather(m_local.keys), pts=mesh.all_gather(m_local.pts),
                       cell_d2=mesh.all_gather(m_local.cell_d2), num_points=counters[:, 0],
                       num_buckets=counters[:, 1], dropped=counters[:, 2])
