"""Port parity: the grouped KNN (`ops/cuda/knn.py`) against the JAX package's
Pallas kernel, run in interpret mode on the CPU, and against its dense
`mapping.knn`.  Mirrors every case of tests/test_pallas_knn.py.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.  Here a numpy model of the
kernel's selection order is held to the same output contract.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu.ops.pallas.knn import knn_grouped as j_knn_grouped
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.mapping import hashgrid as hg
from limovelo_tpu_torch.ops.cuda import knn as gk

from knn_cases import FAR as CASE_FAR
from knn_cases import GROUPS, adversarial_groups

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



# ---------------------------------------------------------------------------
# the card kernel's selection order, modelled in numpy (the kernel itself
# runs only on the card: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

NO_CAND = 0x7FFFFFFF


def _auto_lanes(n_q, threads=256):
    lanes = 32
    while lanes > 1 and lanes * n_q > threads:
        lanes //= 2
    return lanes


def _lex_min(a, b):
    return b if (b[0] < a[0] or (b[0] == a[0] and b[1] < a[1])) else a


def _model_topk(bucket_ids, order_q, centers, map_pts, k, lanes=0):
    """What `csrc/knn_grouped.cu` does, step for step: only present buckets
    (compacted in order) and real slots; L lanes per query, each striding
    over the candidates and keeping a sorted top-k that it replaces on
    strict `<`; then k rounds of an xor-butterfly lexicographic (d, idx)
    minimum over the lanes' heads, the owner popping its head."""
    G, NB = bucket_ids.shape
    S = map_pts.shape[1]
    sq = np.full((G, 64, k), np.inf, np.float32)
    idx = np.zeros((G, 64, k), np.int32)
    for g in range(G):
        rows = np.nonzero(bucket_ids[g] >= 0)[0]
        real = np.nonzero(order_q[g, :, 0] != CASE_FAR)[0]
        if len(rows) == 0 or len(real) == 0:
            continue
        c = centers[g, 0]
        p = map_pts[bucket_ids[g, rows]].reshape(-1, 3) - c          # f32, rounded
        L = lanes or _auto_lanes(len(real))
        for s in real:
            dd = (order_q[g, s] - c) - p
            d = (dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2]
            d = d.tolist()                                            # exact f32 values
            heads = []
            for lane in range(L):
                lst = [(float("inf"), NO_CAND)] * k
                for i in range(lane, len(d), L):
                    if d[i] < lst[-1][0]:
                        pos = sum(e[0] <= d[i] for e in lst)
                        lst = (lst[:pos] + [(d[i], i)] + lst[pos:])[:k]
                heads.append(lst)
            for r in range(k):
                m = [h[0] for h in heads]
                off = L // 2
                while off:
                    m = [_lex_min(m[ln], m[ln ^ off]) for ln in range(L)]
                    off //= 2
                win = m[0]
                for h in heads:
                    if h[0][1] == win[1]:
                        h.pop(0)
                        h.append((float("inf"), NO_CAND))
                sq[g, s, r] = win[0]
                idx[g, s, r] = rows[win[1] // S] * S + win[1] % S if win[1] < len(d) else 0
    return sq, idx


def _case(seed, nb):
    bids, oq, ctr, pts = adversarial_groups(seed, nb)
    return bids, oq, ctr, pts, tuple(torch.as_tensor(a) for a in (bids, oq, ctr, pts))


@pytest.mark.parametrize("k,nb,lanes", [(5, 27, 0), (1, 27, 0), (8, 32, 0), (5, 27, 1),
                                        (8, 27, 4), (5, 32, 32)])
def test_selection_model_matches_plain(k, nb, lanes):
    """The kernel's selection order, in numpy, gives the plain version's d
    and idx on every real slot below 1e16 (the output contract, checked by
    the same helper the card runs), for the lanes rule and for fixed 1, 4
    and 32 lanes per query, with planted ties."""
    bids, oq, ctr, pts, t = _case(7, nb)
    want = gk.group_topk_plain(*t, k)
    got = _model_topk(bids, oq, ctr, pts, k, lanes)
    assert gk.check_topk_contract(t[1], t[0], 64, tuple(map(torch.as_tensor, got)), want) > 0
    if k > 1:                                      # the tie group really ties
        g = GROUPS.index("ties[3]")
        sq_w, idx_w = (v.numpy()[g, 0] for v in want)
        assert sq_w[0] == sq_w[1] < 1e16 and idx_w[0] < idx_w[1]


def _breach(kind, want, oq):
    sq, idx = (v.clone() for v in want)
    real = (oq[..., 0] != CASE_FAR)[..., None].expand_as(sq)
    if kind == "tie_flip":
        tie = real[..., :-1] & (sq[..., :-1] == sq[..., 1:]) & (sq[..., :-1] < 1e16)
        g, s, r = torch.nonzero(tie)[0].tolist()
        idx[g, s, r], idx[g, s, r + 1] = idx[g, s, r + 1].clone(), idx[g, s, r].clone()
    elif kind == "d_ulp":
        g, s, r = torch.nonzero(real & (sq < 1e16))[0].tolist()
        sq[g, s, r] = torch.nextafter(sq[g, s, r], torch.tensor(np.inf))
    elif kind == "idx_range":
        idx[-1, -1, -1] = idx.new_tensor(-1)
    elif kind == "far_low":
        g, s, r = torch.nonzero(real & (sq >= 1e16))[0].tolist()
        sq[g, s, r] = 1.0
    return sq, idx


@pytest.mark.parametrize("kind", ["plain", "tie_flip", "d_ulp", "idx_range", "far_low"])
def test_contract_check(kind):
    """`check_topk_contract` (used by chip_smoke.py and the card test)
    accepts the plain version against itself and rejects a flipped tie
    index, a d one ulp off, an index out of range and a false neighbour."""
    bids, oq, ctr, pts, t = _case(3, 27)
    want = gk.group_topk_plain(*t, 8)
    if kind == "plain":
        assert gk.check_topk_contract(t[1], t[0], 64, gk.group_topk_plain(*t, 8), want) > 0
        return
    with pytest.raises(AssertionError):
        gk.check_topk_contract(t[1], t[0], 64, _breach(kind, want, t[1]), want)


def test_group_queries_int32_ids(rng):
    """`group_queries` gives int32 bucket ids, as the JAX package does, and
    the same ids (the kernel takes them as they are)."""
    from limovelo_tpu.ops.pallas.knn import group_queries as j_group_queries

    mj, mt, world = _pair_map(rng)
    q = (world[rng.choice(len(world), 256, replace=False)]
         + rng.normal(0, 0.05, (256, 3))).astype(np.float32)
    for rings, mb in ((1, None), (3, 32)):
        grp = gk.group_queries(mt, T(q), PT, 128, rings=rings, max_buckets=mb)
        ref = j_group_queries(mj, jnp.asarray(q), PJ, 128, rings=rings, max_buckets=mb)
        assert grp.bucket_ids.dtype == torch.int32
        np.testing.assert_array_equal(grp.bucket_ids.numpy(), np.asarray(ref[0]))
