"""Grouped hash-grid KNN in plain PyTorch: a frozen copy of the plain half of
`limovelo_tpu_torch/ops/cuda/knn.py` (grouping, the per-group top-k that the
CUDA kernel must reproduce bit for bit, and the gather back to query order).

Queries are sorted by coarse voxel and packed into groups of at most
GROUP_CAP that share one 27-bucket neighbourhood; every query of a group
takes the k nearest of its group's NB·64 candidate slots, ties to the lowest
flat index.  Queries whose group falls beyond `g_max` come back invalid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..mapping.hashgrid import (
    _VALID_D2_MAX,
    FAR,
    GridParams,
    HashGridMap,
    _fine_coords,
    _lookup_buckets,
    _neighbor_offsets,
    nearest_buckets,
)
from .voxel import lexsort

GROUP_CAP = 64          # queries per group (larger voxel groups split)


class Groups(NamedTuple):
    bucket_ids: torch.Tensor   # (g_max, NB) int32 — neighbour buckets (-1 absent)
    group_of: torch.Tensor     # (N,) int64 — group of each query (-1: overflowed)
    rank_of: torch.Tensor      # (N,) int64 — slot within its group
    order_q: torch.Tensor      # (g_max, GROUP_CAP, 3) — queries per slot (FAR vacant)
    centers: torch.Tensor      # (g_max, 1, 3) — leader bucket centre (recentring)


def group_queries(m: HashGridMap, queries: torch.Tensor, params: GridParams,
                  g_max: int, rings: int = 1, max_buckets: Optional[int] = None) -> Groups:
    """Sort queries by coarse voxel, pack into ≤GROUP_CAP groups and resolve
    each group's neighbour buckets.  Every row of `queries` is grouped,
    padding rows included (they overflow `g_max` like any other)."""
    N = queries.shape[0]
    dev = queries.device
    fine = _fine_coords(queries, params.voxel_size)
    coarse = torch.div(fine, params.coarse_factor, rounding_mode="floor")

    order = lexsort((coarse[:, 2], coarse[:, 1], coarse[:, 0]))
    cs = coarse[order]
    qs = queries[order]

    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          torch.any(cs[1:] != cs[:-1], dim=-1)])
    idx = torch.arange(N, device=dev)
    starts = torch.cummax(torch.where(is_first, idx, -1), 0).values
    rank = idx - starts
    new_group = is_first | (rank % GROUP_CAP == 0)
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    slot = rank % GROUP_CAP

    # rows beyond g_max land in a spare row g_max, sliced off afterwards
    in_range = gid < g_max
    gid_c = torch.where(in_range, gid, g_max)
    lead = torch.where(new_group & in_range, gid_c, g_max)
    leader_coarse = torch.zeros((g_max + 1, 3), dtype=torch.int32, device=dev)
    leader_coarse.index_put_((lead,), cs)
    leader_coarse = leader_coarse[:g_max]
    group_active = torch.zeros(g_max + 1, dtype=torch.bool, device=dev)
    group_active.index_put_((lead,), torch.ones_like(lead, dtype=torch.bool))
    group_active = group_active[:g_max]

    offs = torch.as_tensor(_neighbor_offsets(rings), device=dev)
    nb_coords = leader_coarse[:, None, :] + offs[None, :, :]
    bucket_ids = _lookup_buckets(m.keys, nb_coords, params, dtype=torch.int32)
    bucket_ids = torch.where(group_active[:, None], bucket_ids, -1)

    cs_size = params.coarse_size
    if max_buckets is not None and max_buckets < bucket_ids.shape[1]:
        ctr = (leader_coarse.to(queries.dtype) + 0.5) * cs_size
        bucket_ids = nearest_buckets(bucket_ids, nb_coords, ctr, cs_size, max_buckets)

    order_q = torch.full((g_max + 1, GROUP_CAP, 3), FAR, dtype=queries.dtype, device=dev)
    order_q.index_put_((gid_c, slot), qs)
    order_q = order_q[:g_max]

    centers = ((leader_coarse.to(queries.dtype) + 0.5)
               * (params.voxel_size * params.coarse_factor))[:, None, :]

    group_of = torch.full((N,), -1, dtype=torch.int64, device=dev)
    group_of.index_put_((order,), torch.where(in_range, gid, -1))
    rank_of = torch.zeros((N,), dtype=torch.int64, device=dev)
    rank_of.index_put_((order,), slot)
    return Groups(bucket_ids, group_of, rank_of, order_q.contiguous(), centers.contiguous())


def group_topk_plain(bucket_ids, order_q, centers, map_pts, k: int, chunk: int = 512):
    """For every group, the k smallest squared distances (and flat
    `bucket*S + slot` indices) from each query slot to the group's NB·S
    candidates, ties to the lowest index: recentre on the group centre, then
    ((dx·dx + dy·dy) + dz·dz).  `chunk` groups at a time (the result does
    not depend on it)."""
    G, NB = bucket_ids.shape
    S = map_pts.shape[1]
    dev = order_q.device
    sq = torch.empty((G, GROUP_CAP, k), dtype=torch.float32, device=dev)
    idx = torch.empty((G, GROUP_CAP, k), dtype=torch.int32, device=dev)
    for g0 in range(0, G, chunk):
        g1 = min(g0 + chunk, G)
        b = bucket_ids[g0:g1].to(torch.int64)
        ctr = centers[g0:g1]                                         # (c,1,3)
        cand = map_pts[torch.clamp(b, min=0)]                        # (c,NB,S,3)
        cand = torch.where((b >= 0)[..., None, None], cand, torch.full_like(cand, FAR))
        cand = (cand - ctr[:, :, None, :]).reshape(g1 - g0, NB * S, 3)
        q = order_q[g0:g1] - ctr                                     # (c,64,3)
        dx = q[:, :, None, 0] - cand[:, None, :, 0]
        dy = q[:, :, None, 1] - cand[:, None, :, 1]
        dz = q[:, :, None, 2] - cand[:, None, :, 2]
        d = dx * dx + dy * dy
        d = d + dz * dz                                              # (c,64,NB*S)
        del dx, dy, dz
        for j in range(k):
            best, arg = torch.min(d, dim=-1)     # first (lowest) index of the minimum
            sq[g0:g1, :, j] = best
            idx[g0:g1, :, j] = arg.to(torch.int32)
            d.scatter_(-1, arg[..., None], float("inf"))
    return sq, idx


def _gather(m: HashGridMap, grp: Groups, sq_g, idx_g, S: int):
    """Winning coordinates, back in query order."""
    ok = grp.group_of >= 0
    g_safe = torch.where(ok, grp.group_of, 0)
    sq = sq_g[g_safe, grp.rank_of]                                # (N,k)
    fidx = idx_g[g_safe, grp.rank_of].to(torch.int64)             # flat NB*S+slot
    valid = ok[:, None] & (sq < _VALID_D2_MAX)
    bid = grp.bucket_ids[g_safe[:, None], fidx // S]
    nb = m.pts[torch.where(bid >= 0, bid, 0), fidx % S]           # (N,k,3)
    sq = torch.where(valid, sq, torch.full_like(sq, float("inf")))
    return nb, sq, valid


def knn_grouped_plain(m: HashGridMap, queries: torch.Tensor, params: GridParams, k: int = 5,
                      g_max: Optional[int] = None, rings: int = 1,
                      max_buckets: Optional[int] = None):
    """(neighbors (N,k,3), sq_dists (N,k) ascending, valid (N,k)) of the
    grouped search; `g_max` defaults to max(N // 4, 64) groups."""
    if g_max is None:
        g_max = max(queries.shape[0] // 4, 64)
    grp = group_queries(m, queries, params, g_max, rings=rings, max_buckets=max_buckets)
    sq_g, idx_g = group_topk_plain(grp.bucket_ids, grp.order_q, grp.centers, m.pts, k)
    return _gather(m, grp, sq_g, idx_g, params.slots)
