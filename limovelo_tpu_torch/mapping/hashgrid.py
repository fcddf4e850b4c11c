"""Device-resident voxel hash-grid map with batched KNN (port of
`limovelo_tpu/mapping/hashgrid.py`).

- The world is divided into fine voxels (`map_voxel_size`, 0.2 m) grouped
  into coarse buckets of `map_coarse_factor`³ fine cells (4³ = 64 slots of
  a 0.8 m bucket).
- A bucket lives in an open-addressing hash table keyed by its integer
  coarse coordinate.  A stored point's slot within its bucket is its
  fine-cell offset, so at most one point per fine voxel exists.
- KNN gathers the 3³ neighbouring buckets (or the tiered budget of a wider
  envelope), computes every candidate distance and keeps the k nearest.

`insert` updates the map's point tables in place (they are the large
tensors: 100 MB of points at the default table size) and returns the map
with its new keys and counters; `prune` writes all three tables in place.
The map passed to either must not be used again.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.voxel import lexsort, sq_norm3
from ..runtime import profiling

EMPTY_KEY = -(2 ** 31)         # never-used bucket (stops probes)
TOMBSTONE_KEY = -(2 ** 31) + 1  # pruned bucket: probes continue past it
FAR = 1.0e9           # coordinate sentinel for empty point slots: any query is
                      # ≥ ~1e18 away, so empty slots lose every distance contest
_VALID_D2_MAX = 1.0e16  # any true neighbour is closer; sentinel slots are ~1e18
_INT32_MAX = 2 ** 31 - 1


class HashGridMap(NamedTuple):
    keys: torch.Tensor        # (T, 3) int32 coarse voxel coords; EMPTY_KEY = free
    pts: torch.Tensor         # (T, S, 3) f32 stored points (FAR = empty slot)
    cell_d2: torch.Tensor     # (T, S) f32 dist² of stored point to fine-cell
                              #   centre; +inf = empty slot
    num_points: torch.Tensor  # () int32
    num_buckets: torch.Tensor # () int32 occupied buckets
    dropped: torch.Tensor     # () int32 cumulative inserts lost to probe-chain
                              #   exhaustion (the map-saturation signal)


class GridParams(NamedTuple):
    """Static map geometry."""

    table_size: int = 1 << 17
    coarse_factor: int = 4
    voxel_size: float = 0.2
    probe_length: int = 8

    @property
    def slots(self) -> int:
        return self.coarse_factor ** 3

    @property
    def coarse_size(self) -> float:
        return self.voxel_size * self.coarse_factor

    @classmethod
    def from_config(cls, config) -> "GridParams":
        return cls(
            table_size=config.map_table_size,
            coarse_factor=config.map_coarse_factor,
            voxel_size=config.map_voxel_size,
            probe_length=config.map_probe_length,
        )


def make_map(params: GridParams, dtype=torch.float32, device="cuda") -> HashGridMap:
    T, S = params.table_size, params.slots
    i32 = dict(dtype=torch.int32, device=device)
    return HashGridMap(
        keys=torch.full((T, 3), EMPTY_KEY, **i32),
        pts=torch.full((T, S, 3), FAR, dtype=dtype, device=device),
        cell_d2=torch.full((T, S), float("inf"), dtype=dtype, device=device),
        num_points=torch.zeros((), **i32),
        num_buckets=torch.zeros((), **i32),
        dropped=torch.zeros((), **i32),
    )


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

_PRIMES = (73856093, 19349669, 83492791)
_U32 = 0xFFFFFFFF


def _hash_coords(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of int32 coords (..., 3) → bucket index [0, table_size).

    The reference wraps in uint32; torch has no uint32 remainder, so the
    same arithmetic runs in int64 with every product masked to 32 bits."""
    c = coords.to(torch.int64) & _U32
    h = (((c[..., 0] * _PRIMES[0]) & _U32)
         ^ ((c[..., 1] * _PRIMES[1]) & _U32)
         ^ ((c[..., 2] * _PRIMES[2]) & _U32))
    return (h % table_size).to(torch.int32)


def _fine_coords(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(pts / voxel_size), computed as a product with the float32
    reciprocal: what the JAX package's compiled code does with its constant
    voxel size, so both assign every point to the same voxel."""
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    return torch.floor(pts * inv).to(torch.int32)


def _split_coords(fine: torch.Tensor, factor: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fine coord → (coarse coord, slot index within bucket)."""
    coarse = torch.div(fine, factor, rounding_mode="floor")
    local = fine - coarse * factor          # in [0, factor)
    slot = (local[..., 0] * factor + local[..., 1]) * factor + local[..., 2]
    return coarse, slot


def _is_key(keys: torch.Tensor, value: int) -> torch.Tensor:
    return torch.all(keys == value, dim=-1)


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------


def _dedup_per_fine_cell(fine, d2, mask):
    """Keep, per fine voxel, only the point nearest its cell centre: sort by
    (x, y, z, d2) and keep the first of each run of equal fine coords."""

    big = torch.full_like(fine[:, 0], _INT32_MAX)
    fx = torch.where(mask, fine[:, 0], big)
    fy = torch.where(mask, fine[:, 1], big)
    fz = torch.where(mask, fine[:, 2], big)
    order = lexsort((d2, fz, fy, fx))
    fs = fine[order]
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=fine.device),
                              torch.all(fs[1:] == fs[:-1], dim=-1)])
    keep_sorted = (~same_as_prev) & mask[order]
    return torch.zeros_like(mask).index_put_((order,), keep_sorted)


def _find_or_claim_buckets(m: HashGridMap, coarse, active, params: GridParams):
    """Resolve the table bucket for each coarse coord, claiming empty buckets.

    Returns (keys', bucket_idx (N,), found mask).  Bounded linear probing;
    batch-internal claim conflicts are resolved by a scatter-min of the row
    index (deterministic winner), losers retry at the same offset.  Rounds
    stop early once no row is pending (later rounds would change nothing)."""
    N = coarse.shape[0]
    T = params.table_size
    dev = coarse.device
    h0 = _hash_coords(coarse, T).to(torch.int64)
    # working copy with one spare row (index T) that absorbs non-writes
    keys = torch.cat([m.keys, torch.full((1, 3), EMPTY_KEY, dtype=torch.int32, device=dev)])

    bucket = torch.full((N,), -1, dtype=torch.int64, device=dev)
    pending = active.clone()
    off = torch.zeros((N,), dtype=torch.int64, device=dev)
    row_ids = torch.arange(N, dtype=torch.int64, device=dev)
    spare = torch.full_like(row_ids, T)

    for _ in range(2 * params.probe_length):
        with profiling.blocking("sync.claim_round"):
            if not bool(pending.any()):
                break
        profiling.count("hashgrid.claim_rounds")
        cand = (h0 + off) % T
        stored = keys[cand]                                 # (N,3)
        is_match = torch.all(stored == coarse, dim=-1) & pending
        claimable = _is_key(stored, EMPTY_KEY) | _is_key(stored, TOMBSTONE_KEY)
        is_empty = claimable & pending & ~is_match

        claims = torch.full((T + 1,), _INT32_MAX, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(0, torch.where(is_empty, cand, spare), row_ids, "amin")
        won = is_empty & (claims[cand] == row_ids)
        keys.index_put_((torch.where(won, cand, spare),), coarse)

        resolved = is_match | won
        bucket = torch.where(resolved, cand, bucket)
        pending = pending & ~resolved
        # advance only past buckets held by a different key; claim-race
        # losers re-probe the same offset (the winner may share their key).
        # Capped at the last offset a lookup scans: rows that exhaust it
        # stay pending and are dropped (table too full near this hash).
        occupied_other = pending & ~is_empty
        off = torch.where(occupied_other, torch.clamp(off + 1, max=params.probe_length - 1), off)
    return keys[:T], bucket, active & ~pending


def _lookup_buckets(keys, coarse, params: GridParams, dtype=torch.int64):
    """Read-only probe: coarse coords (..., 3) → bucket index or -1, as
    `dtype` (int32 for the grouped kernel).  Stops once every chain has
    resolved."""
    with profiling.span("hashgrid.lookup"):
        T = params.table_size
        h0 = _hash_coords(coarse, T).to(dtype)
        bucket = torch.full(coarse.shape[:-1], -1, dtype=dtype, device=coarse.device)
        done = torch.zeros(coarse.shape[:-1], dtype=torch.bool, device=coarse.device)
        for i in range(params.probe_length):
            with profiling.blocking("sync.lookup_round"):
                if bool(done.all()):
                    break
            profiling.count("hashgrid.lookup_rounds")
            cand = (h0 + i) % T
            stored = keys[cand]
            is_match = torch.all(stored == coarse, dim=-1)
            # only a never-used bucket terminates a chain; tombstones are probed past
            is_empty = _is_key(stored, EMPTY_KEY)
            bucket = torch.where(is_match & ~done, cand, bucket)
            done = done | is_match | is_empty
        return bucket


def insert(m: HashGridMap, pts, mask, params: GridParams, downsample: bool = True) -> HashGridMap:
    """Add world-frame points to the map.  With downsample=True at most one
    point per fine voxel survives, preferring the point nearest the
    fine-cell centre; a point replaces a stored one only when strictly
    closer to the centre.  Writes `m.pts` and `m.cell_d2` in place."""
    fine = _fine_coords(pts, params.voxel_size)
    center = (fine.to(pts.dtype) + 0.5) * params.voxel_size
    d2 = sq_norm3(pts - center)

    keep = _dedup_per_fine_cell(fine, d2, mask) if downsample else mask
    coarse, slot = _split_coords(fine, params.coarse_factor)
    slot = slot.to(torch.int64)

    was_free = _is_key(m.keys, EMPTY_KEY) | _is_key(m.keys, TOMBSTONE_KEY)
    with profiling.span("hashgrid.claim"):
        keys, bucket, found = _find_or_claim_buckets(m, coarse, keep, params)
    now_free = _is_key(keys, EMPTY_KEY) | _is_key(keys, TOMBSTONE_KEY)
    newly_claimed = torch.sum(was_free & ~now_free)

    # after dedup each (bucket, slot) has at most one incoming writer
    safe_bucket = torch.where(found, bucket, 0)
    incumbent = m.cell_d2[safe_bucket, slot]
    write = found & (d2 < incumbent)
    with profiling.blocking("sync.insert_nonzero"):
        sel = torch.nonzero(write).squeeze(1)
    m.pts.index_put_((bucket[sel], slot[sel]), pts[sel])
    m.cell_d2.index_put_((bucket[sel], slot[sel]), d2[sel])

    n_new = torch.sum(write & ~torch.isfinite(incumbent)).to(torch.int32)
    # points that wanted in but whose probe chain exhausted: counted loss
    n_dropped = torch.sum(keep & ~found).to(torch.int32)
    return HashGridMap(
        keys=keys,
        pts=m.pts,
        cell_d2=m.cell_d2,
        num_points=m.num_points + n_new,
        num_buckets=m.num_buckets + newly_claimed.to(torch.int32),
        dropped=m.dropped + n_dropped,
    )


def prune(m: HashGridMap, center: torch.Tensor, radius: float, params: GridParams) -> HashGridMap:
    """Forget the buckets whose centre lies farther than `radius` from
    `center` (world frame): one elementwise pass over the table that bounds
    map memory on long trajectories.

    A pruned bucket becomes a tombstone (probes continue past it, inserts may
    reclaim it), its slots FAR and +inf; only live buckets are counted, so a
    tombstone is never subtracted twice.  Writes `m.keys`, `m.pts` and
    `m.cell_d2` in place, as `insert` writes its tables: the map passed in
    must not be used again."""
    centers = (m.keys.to(m.pts.dtype) + 0.5) * params.coarse_size
    live = torch.any(m.keys != EMPTY_KEY, dim=-1) & torch.any(m.keys != TOMBSTONE_KEY, dim=-1)
    far = live & (torch.sqrt(sq_norm3(centers - center)) > radius)
    slots_dropped = torch.sum(far[:, None] & torch.isfinite(m.cell_d2)).to(torch.int32)
    m.keys.masked_fill_(far[:, None], TOMBSTONE_KEY)
    m.pts.masked_fill_(far[:, None, None], FAR)
    m.cell_d2.masked_fill_(far[:, None], float("inf"))
    return m._replace(num_points=m.num_points - slots_dropped,
                      num_buckets=m.num_buckets - torch.sum(far).to(torch.int32))


# ---------------------------------------------------------------------------
# KNN
# ---------------------------------------------------------------------------


def _neighbor_offsets(rings: int) -> np.ndarray:
    r = np.arange(-rings, rings + 1)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    return g.astype(np.int32)


def nearest_buckets(bucket, nb_coords, ref, cs: float, max_buckets: int):
    """Tier: keep the `max_buckets` nearest OCCUPIED buckets by the AABB
    lower-bound distance from `ref` (..., 3); ties keep the lower offset
    index, absent buckets sort last."""
    lo = nb_coords.to(ref.dtype) * cs                       # (..., V, 3)
    clamped = torch.minimum(torch.maximum(ref[..., None, :], lo), lo + cs)
    d_lb = torch.sum((clamped - ref[..., None, :]) ** 2, dim=-1)
    d_lb = torch.where(bucket >= 0, d_lb, torch.full_like(d_lb, float("inf")))
    sel = torch.sort(d_lb, dim=-1, stable=True).indices[..., :max_buckets]
    return torch.gather(bucket, -1, sel)


def knn(m: HashGridMap, queries, params: GridParams, k: int = 5, rings: int = 1,
        max_buckets: Optional[int] = None):
    """Batched k-nearest-neighbours over the (2·rings+1)³ coarse buckets
    around each query (the "dense" backend and the grouped kernel's oracle).

    queries: (N, 3) world-frame points.
    Returns (neighbors (N,k,3), sq_dists (N,k) ascending, valid (N,k)).
    `max_buckets` (rings ≥ 2): gather only the nearest occupied buckets by
    AABB lower bound (see `nearest_buckets`)."""
    N = queries.shape[0]
    S = params.slots
    with profiling.blocking("sync.offsets"):
        offs = torch.as_tensor(_neighbor_offsets(rings), device=queries.device)
    V = offs.shape[0]

    fine = _fine_coords(queries, params.voxel_size)
    coarse = torch.div(fine, params.coarse_factor, rounding_mode="floor")
    nb_coords = coarse[:, None, :] + offs[None, :, :]       # (N,V,3)
    bucket = _lookup_buckets(m.keys, nb_coords, params)     # (N,V)

    if max_buckets is not None and max_buckets < V:
        bucket = nearest_buckets(bucket, nb_coords, queries, params.coarse_size, max_buckets)
        V = max_buckets

    safe = torch.where(bucket >= 0, bucket, 0)
    cand = m.pts[safe]                                      # (N,V,S,3)
    d2 = sq_norm3(cand - queries[:, None, None, :])
    d2 = torch.where((bucket >= 0)[..., None], d2, torch.full_like(d2, float("inf")))
    d2 = d2.reshape(N, V * S)

    sq, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    valid = sq < _VALID_D2_MAX
    nb = torch.gather(cand.reshape(N, V * S, 3), 1, idx[..., None].expand(N, k, 3))
    return nb, torch.where(valid, sq, torch.full_like(sq, float("inf"))), valid
