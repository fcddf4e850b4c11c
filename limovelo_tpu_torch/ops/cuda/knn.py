"""Grouped hash-grid KNN: a hand-written CUDA kernel for the match's map
query (port of `limovelo_tpu/ops/pallas/knn.py`).

1. `group_queries` (plain PyTorch) sorts the queries by coarse voxel, packs
   them into groups of at most GROUP_CAP queries that share one bucket
   neighbourhood, and resolves each group's NB neighbour buckets once
   (1-ring: the 27 buckets around the group leader's voxel; tiered: the
   `max_buckets` nearest occupied ones).
2. `group_topk` computes, per group, every query's k nearest of the
   NB·64 candidate slots: on a CUDA tensor by launching the kernel in
   `csrc/knn_grouped.cu`, on a CPU tensor by `group_topk_plain`.
3. A post-pass gathers the winning coordinates and un-permutes to query
   order.

Returns `mapping.hashgrid.knn` shapes and semantics: (neighbors (N,k,3),
sq_dists (N,k) ascending, valid (N,k)).  Queries whose group falls beyond
`g_max` come back valid=False.

The kernel's output contract against `group_topk_plain` (checked by
`check_topk_contract`).  A *real* slot is one whose `order_q` x is not FAR
(a group's real slots are a prefix); a bucket is *present* when its id is
>= 0.
- On every real slot, each entry that the plain version gives with
  d < `_VALID_D2_MAX` (1e16) is bit-identical in d and in idx, the flat
  index b·64 + slot over the group's original NB buckets; ties go to the
  lowest index.
- Where the plain version gives d >= 1e16, the kernel gives d >= 1e16
  (+inf allowed) and some idx in [0, NB·64).
- Every output entry is written, vacant slots and groups without work
  included, with an idx in [0, NB·64): `_gather` reads `idx_g[0, rank]` for
  overflowed queries.
The kernel computes only (real slots) × (present buckets) × 64 distances;
everything past that is ≥ 1e16 in the plain version and never valid.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ...mapping.hashgrid import (
    _VALID_D2_MAX,
    FAR,
    GridParams,
    HashGridMap,
    _fine_coords,
    _lookup_buckets,
    _neighbor_offsets,
    nearest_buckets,
)
from ...runtime import profiling
from ..voxel import lexsort
from .build import check_tensor, load

GROUP_CAP = 64          # queries per group (larger voxel groups split)
MAX_K = 8               # the kernel is instantiated for k = 1..8
MAX_NB = 32             # neighbour buckets per group the kernel takes (one warp ballot)


class Groups(NamedTuple):
    bucket_ids: torch.Tensor   # (g_max, NB) int32 — neighbour buckets (-1 absent)
    group_of: torch.Tensor     # (N,) int64 — group of each query (-1: overflowed)
    rank_of: torch.Tensor      # (N,) int64 — slot within its group
    order_q: torch.Tensor      # (g_max, GROUP_CAP, 3) — queries per slot (FAR vacant)
    centers: torch.Tensor      # (g_max, 1, 3) — leader bucket centre (recentring)


def group_queries(m: HashGridMap, queries: torch.Tensor, params: GridParams,
                  g_max: int, rings: int = 1, max_buckets: Optional[int] = None) -> Groups:
    """Sort queries by coarse voxel, pack into ≤GROUP_CAP groups and resolve
    each group's neighbour buckets.  With `max_buckets` the (2r+1)³
    neighbourhood is cut to the nearest occupied buckets by AABB lower bound
    from the leader voxel's centre.  Every row of `queries` is grouped,
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

    with profiling.blocking("sync.offsets"):
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


def group_topk_plain(bucket_ids, order_q, centers, map_pts, k: int, chunk: int = 128):
    """Plain PyTorch version of the kernel: for every group, the k smallest
    squared distances (and flat `bucket*S + slot` indices) from each query
    slot to the group's NB·S candidates, ties to the lowest index.  The
    arithmetic is the kernel's, operation for operation: recentre on the
    group centre, then ((dx·dx + dy·dy) + dz·dz)."""
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


def _launch(bucket_ids, order_q, centers, map_pts, k: int, out=None):
    """Launch `csrc/knn_grouped.cu` on PyTorch's current stream; `out` =
    (sq, idx) are written in place of fresh outputs.  Each launch counts
    `knn_grouped.launches` in the current recorder (runtime/profiling.py)."""
    dev = order_q.device
    G, NB = bucket_ids.shape
    S = map_pts.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the grouped kernel supports 1..{MAX_K}")
    if not 1 <= NB <= MAX_NB:
        raise ValueError(f"{NB} buckets per group: the grouped kernel takes 1..{MAX_NB} "
                         "(rings > 1 needs max_buckets)")
    check_tensor(bucket_ids, "bucket_ids", torch.int32, (G, NB), dev)
    check_tensor(order_q, "order_q", torch.float32, (G, GROUP_CAP, 3), dev)
    check_tensor(centers, "centers", torch.float32, (G, 1, 3), dev)
    check_tensor(map_pts, "map_pts", torch.float32, (map_pts.shape[0], S, 3), dev)
    if out is None:
        out = (torch.empty((G, GROUP_CAP, k), dtype=torch.float32, device=dev),
               torch.empty((G, GROUP_CAP, k), dtype=torch.int32, device=dev))
    sq, idx = out
    check_tensor(sq, "sq", torch.float32, (G, GROUP_CAP, k), dev)
    check_tensor(idx, "idx", torch.int32, (G, GROUP_CAP, k), dev)
    fn = load("knn_grouped").knn_grouped_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    err = fn(bucket_ids.data_ptr(), order_q.data_ptr(), centers.data_ptr(), map_pts.data_ptr(),
             sq.data_ptr(), idx.data_ptr(), G, NB, k, S,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_grouped kernel launch failed: cudaError {err}")
    profiling.count("knn_grouped.launches")
    return sq, idx


def group_topk(bucket_ids, order_q, centers, map_pts, k: int):
    """Per-group top-k: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if order_q.device.type == "cuda":
        return _launch(bucket_ids, order_q, centers, map_pts, k)
    if order_q.device.type != "cpu":
        raise ValueError(f"group_topk: unsupported device {order_q.device}")
    return group_topk_plain(bucket_ids, order_q, centers, map_pts, k)


def _first(mask: torch.Tensor) -> list:
    return torch.nonzero(mask)[0].tolist()


def check_topk_contract(order_q, bucket_ids, slots: int, got, want) -> int:
    """Hold `got` = (sq, idx) of `group_topk` to the kernel's output contract
    (module docstring) against `want`, the plain version's on the same
    inputs.  Raises AssertionError at a breach, naming its (group, slot,
    rank); returns the number of entries that had to agree bit for bit."""
    sq, idx = got
    sq_w, idx_w = want
    if (sq.shape != sq_w.shape or idx.shape != idx_w.shape or sq.dtype != torch.float32
            or idx.dtype != torch.int32):
        raise AssertionError(f"outputs {sq.dtype} {tuple(sq.shape)}, {idx.dtype} "
                             f"{tuple(idx.shape)}; want f32/int32 {tuple(sq_w.shape)}")
    n_cand = bucket_ids.shape[1] * slots
    out_of_range = (idx < 0) | (idx >= n_cand)
    if bool(out_of_range.any()):
        raise AssertionError(f"idx outside [0, {n_cand}) at {_first(out_of_range)}")
    if bool(torch.isnan(sq).any()):
        raise AssertionError(f"NaN distance at {_first(torch.isnan(sq))}")
    real = (order_q[..., 0] != FAR)[..., None].expand_as(sq_w)
    exact = real & (sq_w < _VALID_D2_MAX)
    d_diff = exact & (sq.view(torch.int32) != sq_w.view(torch.int32))
    if bool(d_diff.any()):
        at = tuple(_first(d_diff))
        raise AssertionError(f"d differs at {at}: {float(sq[at])!r} vs {float(sq_w[at])!r}")
    i_diff = exact & (idx != idx_w)
    if bool(i_diff.any()):
        at = tuple(_first(i_diff))
        raise AssertionError(f"idx differs at {at}: {int(idx[at])} vs {int(idx_w[at])}")
    far_low = real & ~(sq_w < _VALID_D2_MAX) & ~(sq >= _VALID_D2_MAX)
    if bool(far_low.any()):
        raise AssertionError(f"d below {_VALID_D2_MAX} where the plain version has none, "
                             f"at {_first(far_low)}")
    return int(exact.sum())


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


def _knn(m, queries, params, k, g_max, rings, max_buckets, topk):
    if g_max is None:
        g_max = max(queries.shape[0] // 4, 64)
    with profiling.span("knn.group"):
        grp = group_queries(m, queries, params, g_max, rings=rings, max_buckets=max_buckets)
    with profiling.span("knn.kernel"):
        sq_g, idx_g = topk(grp.bucket_ids, grp.order_q, grp.centers, m.pts, k)
    with profiling.span("knn.gather"):
        return _gather(m, grp, sq_g, idx_g, params.slots)


def knn_grouped(m: HashGridMap, queries: torch.Tensor, params: GridParams, k: int = 5,
                g_max: Optional[int] = None, rings: int = 1,
                max_buckets: Optional[int] = None):
    """Same contract as `mapping.hashgrid.knn`, through the grouped kernel on
    the card (the plain version on the CPU).  `g_max` defaults to
    max(N // 4, 64) groups."""
    return _knn(m, queries, params, k, g_max, rings, max_buckets, group_topk)


def knn_grouped_plain(m: HashGridMap, queries: torch.Tensor, params: GridParams, k: int = 5,
                      g_max: Optional[int] = None, rings: int = 1,
                      max_buckets: Optional[int] = None):
    """`knn_grouped` with the per-group top-k always in plain PyTorch, on
    whatever device the tensors are (the kernel's reference)."""
    return _knn(m, queries, params, k, g_max, rings, max_buckets, group_topk_plain)
