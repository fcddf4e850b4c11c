"""Port parity: the grouped KNN (`ops/cuda/knn.py`) against the JAX package's
Pallas kernel, run in interpret mode on the CPU, and against its dense
`mapping.knn`.  Mirrors every case of tests/test_pallas_knn.py.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import torch
import jax.numpy as jnp

from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu.ops.pallas.knn import knn_grouped as j_knn_grouped
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.mapping import hashgrid as hg
from limovelo_tpu_torch.ops.cuda import knn as gk

torch.set_num_threads(1)

TABLE = 1 << 12


def T(a):
    return torch.as_tensor(np.array(a))


def _pair_map(rng, n=4096, center=(150.0, 80.0, 5.0)):
    """Scan-like world (ground disc + walls) far from the origin, so the
    recentred distance is exercised; built by the JAX package's insert and
    carried into the port."""
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(2, 25, n)
    x = center[0] + r * np.cos(ang)
    y = center[1] + r * np.sin(ang)
    z = center[2] + np.where(rng.random(n) < 0.3, rng.uniform(0, 3, n), rng.normal(0, 0.05, n))
    pts = np.stack([x, y, z], -1).astype(np.float32)
    pj = jhg.GridParams(table_size=TABLE)
    mj = jhg.insert(jhg.make_map(pj), jnp.asarray(pts), jnp.ones(n, bool), pj)
    return mj, _port(mj), pts


def _port(mj):
    return interop.map_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()}, "cpu")


PJ, PT = jhg.GridParams(table_size=TABLE), hg.GridParams(table_size=TABLE)


def _check_same(port, ref, atol=1e-5, coords=True):
    """Same valid mask; d² within `atol` on valid entries (the Pallas kernel
    expands ‖q−p‖² as ‖q‖²+[q,1]·[−2p,‖p‖²] on recentred coordinates, the
    port subtracts first); neighbour coordinates gathered from the same
    table rows, so equal to 1e-6."""
    nbt, sqt, vt = (interop.to_numpy(v) for v in port)
    nbj, sqj, vj = (np.asarray(v) for v in ref)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(sqt[vj], sqj[vj], rtol=0, atol=atol)
    if coords:
        np.testing.assert_allclose(nbt[vj], nbj[vj], rtol=0, atol=1e-6)
    assert np.all(np.isinf(sqt[~vt]))


def test_matches_pallas_and_dense(rng):
    mj, mt, world = _pair_map(rng)
    q = (world[rng.choice(len(world), 512, replace=False)]
         + rng.normal(0, 0.05, (512, 3))).astype(np.float32)
    port = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=512)
    _check_same(port, j_knn_grouped(mj, jnp.asarray(q), PJ, k=5, g_max=512, interpret=True))
    _check_same(port, jhg.knn(mj, jnp.asarray(q), PJ, k=5, rings=1))
    # on the CPU the wrapper takes the plain version
    for a, b in zip(gk.knn_grouped(mt, T(q), PT, k=5, g_max=512), port):
        assert torch.equal(a, b)


def test_group_overflow_marks_invalid(rng):
    mj, mt, world = _pair_map(rng)
    q = world[:256]
    g_max = 8  # far fewer groups than distinct coarse voxels
    port = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=g_max)
    _check_same(port, j_knn_grouped(mj, jnp.asarray(q), PJ, k=5, g_max=g_max, interpret=True))
    valid = port[2].numpy()
    assert not valid.all() and valid.any()
    grp = gk.group_queries(mt, T(q), PT, g_max)
    # exactly the overflowed queries come back empty
    assert np.all(~valid[grp.group_of.numpy() < 0])


def test_group_capacity_split(rng):
    """More than GROUP_CAP queries in one coarse voxel split across groups
    and all still resolve."""
    mj, mt, world = _pair_map(rng)
    q = (world[0] + rng.uniform(-0.3, 0.3, (gk.GROUP_CAP + 40, 3))).astype(np.float32)
    port = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=16)
    _check_same(port, j_knn_grouped(mj, jnp.asarray(q), PJ, k=5, g_max=16, interpret=True))
    _check_same(port, jhg.knn(mj, jnp.asarray(q), PJ, k=5, rings=1))
    grp = gk.group_queries(mt, T(q), PT, 16)
    assert len(set(grp.group_of.tolist())) >= 2


def test_empty_map_all_invalid(rng):
    mt = hg.make_map(PT, device="cpu")
    q = rng.uniform(-5, 5, (128, 3)).astype(np.float32)
    nb, sq, valid = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=128)
    assert not valid.any() and torch.isinf(sq).all()


def test_tiered_rings3_recall_vs_exact(rng):
    """Tiered envelope (rings=3, max_buckets=32) on a sparse map where the
    1-ring misses true neighbours: recall ≥ 0.995 against an exact oracle
    (the bar of tests/test_knn_fidelity.py), and the JAX kernel's results."""
    n = 1500
    world = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                      rng.normal(0, 1.0, n)], -1).astype(np.float32)
    mj = jhg.insert(jhg.make_map(PJ), jnp.asarray(world), jnp.ones(n, bool), PJ)
    mt = _port(mj)
    nq = 256
    q = np.stack([rng.uniform(-30, 30, nq), rng.uniform(-30, 30, nq),
                  rng.normal(0, 1.0, nq)], -1).astype(np.float32)
    port = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=256, rings=3, max_buckets=32)
    _check_same(port, j_knn_grouped(mj, jnp.asarray(q), PJ, k=5, g_max=256, rings=3,
                                    max_buckets=32, interpret=True))

    gate = 2.0  # MAX_DIST_PLANE
    d2 = ((q[:, None, :] - world[None, :, :]) ** 2).sum(-1)
    od2 = np.sort(d2, axis=1)[:, :5]
    got, gv = port[1].numpy(), port[2].numpy()
    hits = wanted = 0
    for i in range(nq):
        g = np.sort(got[i][gv[i] & (got[i] <= gate * gate)])
        w = od2[i][od2[i] <= gate * gate]
        wanted += len(w)
        hits += sum(bool(np.any(np.abs(g - wv) <= 1e-4)) for wv in w)
    assert hits / max(wanted, 1) >= 0.995


def test_tiered_agrees_with_dense(rng):
    """On the dense scan-like map the group-tiered search agrees with the
    dense per-query tiered search on every pair both call valid (1e-4: the
    tier bases differ, per group vs per query)."""
    mj, mt, world = _pair_map(rng)
    q = (world[rng.choice(len(world), 256, replace=False)]
         + rng.normal(0, 0.05, (256, 3))).astype(np.float32)
    port = gk.knn_grouped_plain(mt, T(q), PT, k=5, g_max=256, rings=3, max_buckets=32)
    nbd, sqd, vd = hg.knn(mt, T(q), PT, k=5, rings=3, max_buckets=32)
    v = vd.numpy() & port[2].numpy()
    np.testing.assert_allclose(port[1].numpy()[v], sqd.numpy()[v], rtol=0, atol=1e-4)
    assert v.mean() > 0.95

