"""Port parity: the voxel hash-grid map (hash, insert, dense KNN) against the
JAX package on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.mapping import hashgrid as hg

torch.set_num_threads(1)

PARAMS = dict(table_size=1 << 12)


def T(a):
    return torch.as_tensor(np.array(a))


def _world(rng, n, center=(40.0, -25.0, 2.0)):
    """Ground disc and walls around `center`, with negative coordinates in
    the mix (floor-division and hash paths of negative voxels)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(1, 20, n)
    x = center[0] + r * np.cos(ang) - 45.0 * (rng.random(n) < 0.5)
    y = center[1] + r * np.sin(ang)
    z = center[2] + np.where(rng.random(n) < 0.3, rng.uniform(0, 3, n), rng.normal(0, 0.03, n))
    return np.stack([x, y, z], -1).astype(np.float32)


def _as_set(m):
    """The map's content as a set of (coarse key, slot, point) rows."""
    keys, pts, d2 = (np.asarray(v) for v in (m.keys, m.pts, m.cell_d2))
    b, s = np.nonzero(np.isfinite(d2))
    return {(*keys[i].tolist(), int(j), *pts[i, j].tolist()) for i, j in zip(b, s)}


def _port_map(mj):
    return interop.map_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()}, "cpu")


def test_hash_coords_wraps_like_uint32(rng):
    """Exact: int64 arithmetic masked to 32 bits reproduces the uint32 wrap
    of the JAX package for negative and large coordinates."""
    c = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31 - 1, (500, 3)),
        rng.integers(-300, 300, (500, 3)),
        np.array([[-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 0], [-2 ** 31, -2 ** 31, -2 ** 31]]),
    ]).astype(np.int32)
    for table in (1 << 12, 1 << 17, 1000003):
        np.testing.assert_array_equal(hg._hash_coords(T(c), table).numpy(),
                                      np.asarray(jhg._hash_coords(jnp.asarray(c), table)))


def test_insert_same_map(rng):
    """Two inserts (the second overlapping the first, so the nearest-to-
    centre replacement rule runs): the same (key, slot, point) set and the
    same point, bucket and drop counters."""
    pj, pt = jhg.GridParams(**PARAMS), hg.GridParams(**PARAMS)
    mj, mt = jhg.make_map(pj), hg.make_map(pt, device="cpu")
    for n, keep in ((3000, 0.9), (3000, 0.8)):
        w = _world(rng, n)
        mask = rng.random(n) < keep
        mj = jhg.insert(mj, jnp.asarray(w), jnp.asarray(mask), pj)
        mt = hg.insert(mt, T(w), T(mask), pt)
        assert _as_set(mt) == _as_set(mj)
        for f in ("num_points", "num_buckets", "dropped"):
            assert int(getattr(mt, f)) == int(getattr(mj, f)), f
    assert int(mt.num_points) > 2000


def test_insert_saturation_counts_drops(rng):
    """A table too small for the cloud: both sides drop the same points and
    count them alike."""
    pj, pt = jhg.GridParams(table_size=64, probe_length=4), hg.GridParams(table_size=64, probe_length=4)
    w = _world(rng, 2000)
    mj = jhg.insert(jhg.make_map(pj), jnp.asarray(w), jnp.ones(2000, bool), pj)
    mt = hg.insert(hg.make_map(pt, device="cpu"), T(w), torch.ones(2000, dtype=torch.bool), pt)
    assert int(mt.dropped) == int(mj.dropped) > 0
    assert _as_set(mt) == _as_set(mj)
    np.testing.assert_array_equal(mt.keys.numpy(), np.asarray(mj.keys))


@pytest.mark.parametrize("rings,max_buckets", [(1, None), (3, 32)])
def test_dense_knn(rng, rings, max_buckets):
    """Same valid mask, d² within 1e-5 on valid entries (the two sides sum
    the three squared components in another order).  Indices are not
    compared: equal distances may come out in another order."""
    pj, pt = jhg.GridParams(**PARAMS), hg.GridParams(**PARAMS)
    w = _world(rng, 5000)
    mj = jhg.insert(jhg.make_map(pj), jnp.asarray(w), jnp.ones(len(w), bool), pj)
    mt = _port_map(mj)
    q = np.concatenate([
        w[rng.choice(len(w), 400, replace=False)] + rng.normal(0, 0.1, (400, 3)),
        rng.uniform(-60, 60, (100, 3)),      # many far from any point
    ]).astype(np.float32)
    nbj, sqj, vj = jhg.knn(mj, jnp.asarray(q), pj, k=5, rings=rings, max_buckets=max_buckets)
    nbt, sqt, vt = hg.knn(mt, T(q), pt, k=5, rings=rings, max_buckets=max_buckets)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.mean() > 0.5
    np.testing.assert_allclose(sqt.numpy()[vj], np.asarray(sqj)[vj], rtol=0, atol=1e-5)
    assert np.all(np.isinf(sqt.numpy()[~vj]))
    # each returned neighbour is at the distance reported for it
    d2 = ((nbt.numpy() - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2[vj], sqt.numpy()[vj], rtol=1e-4, atol=1e-5)
