"""Fixed-shape voxel-grid downsample (port of `limovelo_tpu/ops/voxel.py`).

One representative per `leaf`-sized voxel: the input point nearest the
voxel's centroid (the medoid — a centroid of points straddling a surface
junction lies off every surface, the medoid stays on a measured one).  The
output keeps the input's padded length with a validity mask and the real
count; valid rows come first in voxel order.

`onion_downsample` is the reference's range-banded decimation, kept as API
surface (the reference pipeline uses the voxel grid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INT32_MAX = 2 ** 31 - 1


class Downsampled(NamedTuple):
    pts: torch.Tensor    # (N, 3) — valid prefix, zeros after
    mask: torch.Tensor   # (N,)
    count: torch.Tensor  # () int32
    idx: torch.Tensor    # (N,) int32 — input index of each output row (0 after)


def sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last dim (size 3) as fma(z, z, fma(y, y, x·x)):
    the rounding of the JAX package's compiled CPU code, so that ties
    between nearly equidistant points (medoids, map slots) resolve alike."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.addcmul(torch.addcmul(x * x, y, y), z, z)


def lexsort(keys) -> torch.Tensor:
    """Indices sorting by `keys`, the LAST key primary (numpy/jnp lexsort
    order), ties kept in input order: chained stable sorts, first key to
    last."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, leaf: float) -> Downsampled:
    """One representative per voxel: the input point nearest the voxel's
    centroid; among equally near points the lowest sorted index wins."""
    N = pts.shape[0]
    dev = pts.device
    # true division by a device tensor: CUDA divides by a Python scalar as a
    # product with its reciprocal, which moves points across voxel borders
    leaf_t = torch.full((), leaf, dtype=pts.dtype, device=dev)
    fine = torch.floor(pts / leaf_t).to(torch.int32)
    big = torch.full_like(fine[:, 0], _INT32_MAX)
    fx = torch.where(mask, fine[:, 0], big)
    fy = torch.where(mask, fine[:, 1], big)
    fz = torch.where(mask, fine[:, 2], big)

    order = lexsort((fz, fy, fx))
    fs = torch.stack([fx, fy, fz], dim=-1)[order]
    ps = pts[order]
    ms = mask[order]

    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          torch.any(fs[1:] != fs[:-1], dim=-1)]) & ms
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1
    seg = torch.where(ms, seg, N - 1)                   # padding → last segment

    zeros3 = torch.zeros_like(ps)
    sums = torch.zeros_like(ps).index_add_(0, seg, torch.where(ms[:, None], ps, zeros3))
    cnts = torch.zeros(N, dtype=pts.dtype, device=dev).index_add_(0, seg, ms.to(pts.dtype))
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]

    # medoid: the actual point nearest its voxel centroid
    d2 = sq_norm3(ps - centroids[seg])
    d2 = torch.where(ms, d2, torch.full_like(d2, float("inf")))
    best_d2 = torch.full((N,), float("inf"), dtype=pts.dtype, device=dev).scatter_reduce(
        0, seg, d2, "amin", include_self=True)
    pos = torch.arange(N, device=dev)
    pos_key = torch.where(ms & (d2 <= best_d2[seg]), pos, N)
    best_pos = torch.full((N,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, pos_key, "amin", include_self=True).clamp(0, N - 1)
    reps = ps[best_pos]
    orig_idx = order[best_pos].to(torch.int32)

    n_vox = torch.sum(is_first)
    out_mask = pos < n_vox
    return Downsampled(
        pts=torch.where(out_mask[:, None], reps, torch.zeros_like(reps)),
        mask=out_mask,
        count=n_vox.to(torch.int32),
        idx=torch.where(out_mask, orig_idx, torch.zeros_like(orig_idx)),
    )


# Range bands of `Compensator::onion_downsample` (Compensator.cpp:165-181):
# (low, high, base decimation divisor).  Points beyond the last band are
# always kept; the divisor is divided by config.downsample_rate.
_ONION_BANDS = (
    (0.0, 4.0, 256),
    (4.0, 6.0, 64),
    (6.0, 9.0, 32),
    (9.0, 12.0, 16),
    (12.0, 22.0, 8),
    (22.0, 30.0, 4),
    (30.0, 50.0, 2),
)


def onion_downsample(pts: torch.Tensor, mask: torch.Tensor, downsample_rate: int) -> Downsampled:
    """Range-banded decimation (`Compensator::onion_downsample`): near points
    decimated hard, far points kept.  In a band with divisor d, a point is
    kept when its index in the window is a multiple of d // rate (every
    point when that is 1); beyond 50 m every point is kept.  The kept points
    come out as a dense prefix in input order (the `voxel_downsample`
    contract)."""
    N = pts.shape[0]
    r = torch.sqrt(sq_norm3(pts))
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)

    keep = r > _ONION_BANDS[-1][1]
    for lo, hi, div in _ONION_BANDS:
        step = div // max(int(downsample_rate), 1)
        in_band = (lo < r) & (r < hi)
        keep = keep | (in_band if step <= 1 else in_band & (idx % step == 0))
    keep = keep & mask

    # stable compaction: kept rows first, each group in input order
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    km = keep[order]
    return Downsampled(
        pts=torch.where(km[:, None], pts[order], torch.zeros_like(pts)),
        mask=km,
        count=torch.sum(keep).to(torch.int32),
        idx=torch.where(km, order.to(torch.int32), torch.zeros_like(idx)),
    )
