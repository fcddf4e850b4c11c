"""Port parity: the map lifecycle — `hashgrid.prune`, `step.mapping_step`,
the offline mapping mode and the prune policy — against the JAX package on
the CPU.

The replays follow tests/test_torch_pipeline.py: both pipelines resolve
telemetry at depth 1 (the JAX one with `defer_readback=False`), one point
bucket and one IMU bucket keep the JAX side to one compile per program.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import limovelo_tpu.ops.pallas.knn as pallas_knn
from limovelo_tpu import Config as JConfig
from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu.step import mapping_step as j_mapping_step
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.config import DynParams
from limovelo_tpu_torch.filter.process import ImuWindow
from limovelo_tpu_torch.io.simulate import (circle_trajectory, corridor_trajectory,
                                            corridor_world, replay_into, room_world, simulate)
from limovelo_tpu_torch.mapping import hashgrid as hg
from limovelo_tpu_torch.runtime.pipeline import LioPipeline
from limovelo_tpu_torch.step import mapping_step

from __graft_entry__ import _make_example
from torch_scenes import save_jax_hd_map, world_cloud

torch.set_num_threads(1)

#: replay positions agree to 5 mm (see tests/test_torch_pipeline.py: a
#: medoid or plane gate may flip on an f32 near-tie)
POS_TOL = 0.005
MAP_FIELDS = ("keys", "pts", "cell_d2", "num_points", "num_buckets", "dropped")


def T(a):
    return torch.as_tensor(np.array(a))


def _assert_same_map(mt, mj):
    """Bit-equal map fields."""
    for f in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)), f)


def _world(rng, n, center=(30.0, -20.0, 2.0)):
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(1, 30, n)
    z = center[2] + np.where(rng.random(n) < 0.3, rng.uniform(0, 3, n), rng.normal(0, 0.03, n))
    return np.stack([center[0] + r * np.cos(ang), center[1] + r * np.sin(ang), z], -1
                    ).astype(np.float32)


def _tconfig(jc):
    return interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})


# ---------------------------------------------------------------------------
# prune
# ---------------------------------------------------------------------------


def test_prune_and_reinsert_match_jax(rng):
    """Bit-equal map fields after an insert, a prune, a second prune at the
    same centre (tombstones are not counted twice, so nothing changes) and a
    reinsertion that reclaims tombstones."""
    pj, pt = jhg.GridParams(table_size=1 << 12), hg.GridParams(table_size=1 << 12)
    w = _world(rng, 6000)
    mj = jhg.insert(jhg.make_map(pj), jnp.asarray(w), jnp.ones(len(w), bool), pj)
    mt = hg.insert(hg.make_map(pt, device="cpu"), T(w), torch.ones(len(w), dtype=torch.bool), pt)
    _assert_same_map(mt, mj)
    center = np.array([35.0, -18.0, 2.0], np.float32)
    for _ in range(2):
        mj = jhg.prune(mj, jnp.asarray(center), jnp.float32(12.0), pj)
        mt = hg.prune(mt, T(center), 12.0, pt)
        _assert_same_map(mt, mj)
    n_tomb = int(np.all(mt.keys.numpy() == hg.TOMBSTONE_KEY, -1).sum())
    assert n_tomb > 100 and int(mt.num_buckets) > 50
    w2 = _world(rng, 4000)
    mj = jhg.insert(mj, jnp.asarray(w2), jnp.ones(len(w2), bool), pj)
    mt = hg.insert(mt, T(w2), torch.ones(len(w2), dtype=torch.bool), pt)
    _assert_same_map(mt, mj)
    assert int(np.all(mt.keys.numpy() == hg.TOMBSTONE_KEY, -1).sum()) < n_tomb


def _colliding_coarse_pair(T_size):
    """Two coarse keys with the same hash: one near the origin, one 40 m
    away along x."""
    near = np.array([[0, 0, 0]], np.int32)
    h_near = int(hg._hash_coords(T(near), T_size)[0])
    far = np.stack([np.full(4000, 50), np.arange(4000) - 2000, np.zeros(4000)], -1).astype(np.int32)
    hits = np.nonzero(hg._hash_coords(T(far), T_size).numpy() == h_near)[0]
    return near[0], far[hits[0]]


def test_prune_duplicate_bucket_fault_matches_jax():
    """Reproduced fault of both packages: a far key A stored at the hash's
    first slot pushes a colliding near key B to the next one.  Pruning A
    leaves a tombstone at the first slot; reinserting B's points claims that
    tombstone, because the claim takes the first tombstone on the probe
    chain before it reaches B's own bucket.  B then owns two buckets, and
    the older one's points are counted but no lookup reaches them.  Both
    packages give bit-equal maps at every step."""
    T_size = 64
    pj, pt = jhg.GridParams(table_size=T_size), hg.GridParams(table_size=T_size)
    key_b, key_a = _colliding_coarse_pair(T_size)
    cs = pt.coarse_size
    pa = ((key_a + 0.5) * cs)[None].astype(np.float32)
    pb = ((key_b + np.array([[0.3, 0.4, 0.5], [0.6, 0.2, 0.7]])) * cs).astype(np.float32)
    mj, mt = jhg.make_map(pj), hg.make_map(pt, device="cpu")
    for pts in (pa, pb):
        mj = jhg.insert(mj, jnp.asarray(pts), jnp.ones(len(pts), bool), pj)
        mt = hg.insert(mt, T(pts), torch.ones(len(pts), dtype=torch.bool), pt)
    mj = jhg.prune(mj, jnp.zeros(3, jnp.float32), jnp.float32(10.0), pj)
    mt = hg.prune(mt, torch.zeros(3), 10.0, pt)
    _assert_same_map(mt, mj)
    assert int(mt.num_buckets) == 1 and int(mt.num_points) == 2
    # B's points again
    mj = jhg.insert(mj, jnp.asarray(pb), jnp.ones(len(pb), bool), pj)
    mt = hg.insert(mt, T(pb), torch.ones(len(pb), dtype=torch.bool), pt)
    _assert_same_map(mt, mj)
    rows_b = np.nonzero(np.all(mt.keys.numpy() == key_b, -1))[0]
    assert len(rows_b) == 2                      # one key, two buckets
    assert int(mt.num_buckets) == 2 and int(mt.num_points) == 4
    # a lookup of B reaches only the first bucket on its chain
    found = hg._lookup_buckets(mt.keys, T(key_b[None]), pt)
    assert int(found[0]) == rows_b.min()


# ---------------------------------------------------------------------------
# mapping_step
# ---------------------------------------------------------------------------


def test_mapping_step_matches_jax():
    """One rotation re-deskewed and inserted into a map that already holds
    the same cloud seen from another pose: bit-equal keys and counters,
    stored points within 1e-5 (the deskew rounds in another order), and the
    global cloud within 5e-5 at 10 m."""
    jc = JConfig(real_time=False, min_dist=0.5, downsample_prec=0.3, map_table_size=1 << 11)
    tc = _tconfig(jc)
    inp_j, m_j, jc, grid_j = _make_example(jc, n_pts=512, n_imu=16)
    grid_t = hg.GridParams.from_config(tc)
    inp = jax.tree.map(np.asarray, inp_j)
    st = lambda x: interop.state_from_numpy(x._asdict(), "cpu")
    x_t2 = inp.x._replace(p=inp.x.p + np.float32([0.2, -0.1, 0.05]))
    m_j = jhg.insert(m_j, jnp.asarray(inp.pts), jnp.asarray(inp.pts_mask), grid_j)
    m_t = interop.map_from_numpy(jax.tree.map(np.asarray, m_j)._asdict(), "cpu")
    n_before = int(m_t.num_points)

    out_j = jax.tree.map(np.asarray, j_mapping_step(
        m_j, inp_j.anchor, inp_j.anchor_t, inp_j.anchor_a, inp_j.anchor_w, inp_j.imus_path,
        jax.tree.map(jnp.asarray, x_t2), inp_j.t2, inp_j.pts, inp_j.pts_t, inp_j.pts_mask,
        inp_j.dyn, jc.static(), grid_j))
    out_t = mapping_step(
        m_t, st(inp.anchor), T(inp.anchor_t), T(inp.anchor_a), T(inp.anchor_w),
        ImuWindow(*(T(v) for v in inp.imus_path)), st(x_t2), T(inp.t2), T(inp.pts),
        T(inp.pts_t), T(inp.pts_mask), DynParams.from_config(tc), grid_t)
    mt, mj = out_t[0], out_j[0]
    for f in ("keys", "num_points", "num_buckets", "dropped"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), getattr(mj, f), f)
    occ = np.isfinite(mj.cell_d2)
    np.testing.assert_array_equal(np.isfinite(mt.cell_d2.numpy()), occ)
    np.testing.assert_allclose(mt.pts.numpy()[occ], mj.pts[occ], rtol=0, atol=1e-5)
    assert int(mt.num_points) > n_before + 100
    np.testing.assert_allclose(out_t[1].numpy(), out_j[1], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(out_t[4].numpy(), out_j[4])


# ---------------------------------------------------------------------------
# pipeline replays
# ---------------------------------------------------------------------------


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(pallas_knn, "knn_grouped",
                        functools.partial(pallas_knn.knn_grouped, interpret=True))


def _growth(records):
    mp = np.array([r.map_points for r in records])
    return np.nonzero(np.diff(mp) > 0)[0]


def test_offline_replay_matches_jax(interpreted_pallas):
    """Offline mapping, grouped KNN on both sides (the JAX side's Pallas
    kernel interpreted): the same record times, collapsed windows and map
    growth events (at most one per rotation of the records' span, at least
    half that), positions within 5 mm, map points within 1 % (a medoid flip
    moves a fine cell or two)."""
    jc = J_DEFAULT.replace(knn_rings=1, knn_backend="pallas", map_table_size=1 << 12,
                           point_buckets=(1024,), imu_buckets=(64,), mapping="offline")
    tc = _tconfig(jc)
    assert tc.mapping_mode == "offline" and tc.static().knn_backend == "grouped"
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), tc,
                   duration=0.9, lidar_lines=8, pts_per_line=128, imu_rate=200.0)

    jp = JLioPipeline(jc, defer_readback=False)
    replay_into(jp, sim)
    jr = jp.result
    tp = LioPipeline(tc, device="cpu")
    replay_into(tp, sim)
    tr = tp.result
    assert tp.timers.counters["knn_grouped.launches"] == 0

    assert len(tr.records) == len(jr.records) >= 6
    assert tp.collapsed_windows == jp.collapsed_windows
    np.testing.assert_array_equal(tr.times, jr.times)
    d = np.linalg.norm(tr.positions - jr.positions, axis=1)
    assert d.max() < POS_TOL, d
    g_t, g_j = _growth(tr.records), _growth(jr.records)
    np.testing.assert_array_equal(g_t, g_j)
    rotations = (tr.times[-1] - tr.times[0]) / tc.full_rotation_time
    assert 0.5 * rotations <= len(g_t) <= rotations + 2
    mp_t = np.array([r.map_points for r in tr.records])
    mp_j = np.array([r.map_points for r in jr.records])
    np.testing.assert_allclose(mp_t, mp_j, rtol=0.01)
    assert [a.t for a in tp._anchors_d] == [a.t for a in jp._anchors_d]
    assert [a.t for a in tp._anchors] == [a.t for a in jp._anchors]


def test_prune_policy_replay_matches_jax(tmp_path):
    """The prune policy on a short corridor run (dense KNN), localizing
    against an HD map of the corridor saved by the JAX package and frozen
    (mode "none"), so that only the prune decisions (cadence, centre,
    radius) change the map: the same record times and `map_buckets` series,
    which falls at each prune, bit-equal maps at the end, positions within
    5 mm.  With online mapping the two packages' f32 roundings move the pose
    by millimetres and the map by a few cells, which after a prune can grow
    into centimetres on a corridor; a frozen map keeps the policy apart from
    that.  A bucket whose centre lies within the two poses' distance of the
    sphere may go on one side only: at this radius every live centre is at
    least 12 mm from it at each of this run's five prunes."""
    jc = J_DEFAULT.replace(knn_backend="xla", knn_rings=1, map_table_size=1 << 13,
                           point_buckets=(1024,), imu_buckets=(32,), map_prune_radius=10.5,
                           map_prune_every=0.3, mapping="none")
    tc = _tconfig(jc)
    world, traj = corridor_world(length=40.0, pillar_every=3.0), corridor_trajectory(speed=4.0)
    sim = simulate(world, traj, tc, duration=2.0, lidar_lines=8, pts_per_line=128,
                   imu_rate=200.0, seed=13, max_range=20.0)
    hd = tmp_path / "corridor.npz"
    save_jax_hd_map(hd, world_cloud(world, traj, np.linspace(0, 2.0, 9), max_range=20.0),
                    jc.map_table_size)

    jp = JLioPipeline.from_hd_map(jc, str(hd), grid=jhg.GridParams.from_config(jc))
    assert not jp.defer_readback
    replay_into(jp, sim)
    tp = LioPipeline.from_hd_map(tc, str(hd), device="cpu")
    replay_into(tp, sim)
    jr, tr = jp.result, tp.result
    np.testing.assert_array_equal(tr.times, jr.times)
    bj = np.array([r.map_buckets for r in jr.records])
    bt = np.array([r.map_buckets for r in tr.records])
    np.testing.assert_array_equal(bt, bj)
    assert np.sum(np.diff(bt) < 0) >= 2
    assert tp._last_prune_t == jp._last_prune_t
    _assert_same_map(tp.map, jax.tree.map(np.asarray, jp.map))
    d = np.linalg.norm(tr.positions - jr.positions, axis=1)
    assert d.max() < POS_TOL, d
