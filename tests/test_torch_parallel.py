"""Port parity of multi-device execution (`limovelo_tpu_torch.parallel`):
the point- and map-sharded steps, the ring KNN, owner-routed inserts and
prunes, the edge-sharded pose graph, the multi-process helpers, the
pipeline with a mesh and the CLI's `--devices`, against the JAX package on a
2-device mesh of this process's virtual CPU devices.

The port's side runs in one world of two gloo ranks on the CPU, spawned once
for the module through `parallel.multihost.spawn` (rendezvous file under
pytest's tmp_path); every rank runs every case (tests/torch_parallel_ranks.py,
which imports no JAX) and each test reads its case's results.  Each JAX run
keeps one point bucket and one IMU bucket.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import limovelo_tpu.ops.pallas.knn as pallas_knn
from limovelo_tpu import Config as JConfig
from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.graph.posegraph import PoseGraph as JPoseGraph
from limovelo_tpu.graph.posegraph import optimize_pose_graph_sharded as j_opt_sharded
from limovelo_tpu.mapping import GridParams as JGrid
from limovelo_tpu.mapping import make_map as j_make_map
from limovelo_tpu.mapping import prune as j_prune
from limovelo_tpu.parallel import map_sharding as j_ms
from limovelo_tpu.parallel.sharding import make_mesh as j_make_mesh
from limovelo_tpu.parallel.sharding import make_sharded_step as j_make_sharded_step
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.graph import PoseGraph, optimize_pose_graph
from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
from limovelo_tpu_torch.mapping.hashgrid import GridParams, insert, knn, make_map
from limovelo_tpu_torch.parallel import map_sharding as ms
from limovelo_tpu_torch.parallel import multihost as mh
from limovelo_tpu_torch.runtime.evaluate import ate_rmse
from limovelo_tpu_torch.step import lio_step

from __graft_entry__ import _make_example
from torch_parallel_ranks import port_inputs, run_cases

torch.set_num_threads(1)

D = 2
POS_TOL = 0.005
#: the ranks' world must finish well inside the suite's limit
WORLD_TIMEOUT_S = 400.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fields(jc):
    """A JAX config's fields, with plain values only (the ranks import no
    JAX class)."""
    d = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    d["Initialization"] = dict(times=tuple(jc.Initialization.times),
                               deltas=tuple(jc.Initialization.deltas))
    return d


def _inputs_dict(inp) -> dict:
    """A JAX StepInputs as numpy fields (what `port_inputs` takes)."""
    inp = _np(inp)
    d = inp._asdict()
    for k in ("anchor", "x", "imus_filter", "imus_path"):
        d[k] = d[k]._asdict()
    d.pop("Q"), d.pop("dyn")
    return d


def _example(**cfg):
    jc = JConfig(real_time=False, min_dist=0.5, downsample_prec=0.3, **cfg)
    inp, _, jc, grid = _make_example(jc, n_pts=1024 if "knn_backend" not in cfg else 512,
                                     n_imu=16)
    return inp, jc, JGrid.from_config(jc)


def _ring_points():
    rng = np.random.default_rng(0)
    return (rng.uniform(-6, 6, size=(4096, 3)).astype(np.float32),
            rng.uniform(-7, 7, size=(512, 3)).astype(np.float32))


#: sized so neither the global nor any local table saturates (the ring KNN
#: equals the unsharded one only while no insert is dropped)
RING_GRID = dict(table_size=1 << 13, coarse_factor=4, voxel_size=0.2, probe_length=16)


def _pose_problem():
    rng = np.random.default_rng(0)
    K = 24
    t = np.linspace(0, 2 * np.pi, K).astype(np.float32)
    ps_true = np.stack([10 * np.cos(t), 10 * np.sin(t), 0 * t], 1).astype(np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy()
    ps0 = ps_true + rng.normal(0, 0.5, ps_true.shape).astype(np.float32)
    ps0[0] = ps_true[0]
    edges = [[], [], [], [], []]
    for k in range(K - 1):
        for e, v in zip(edges, (k, k + 1, np.eye(3, dtype=np.float32),
                                ps_true[k + 1] - ps_true[k], 1.0)):
            e.append(v)
    for e, v in zip(edges, (0, K - 1, np.eye(3, dtype=np.float32), ps_true[-1] - ps_true[0], 5.0)):
        e.append(v)
    return dict(edges=edges, Rs0=Rs, ps0=ps0, iters=8)


def _pipeline_config(**kw):
    """The CLI tests' small configuration (well constrained: the packages'
    f32 roundings keep their runs millimetres apart), dense KNN, "rematch"
    cadence, one point bucket and one IMU bucket."""
    return J_DEFAULT.replace(**{**dict(
        real_time=False, min_dist=0.5, downsample_prec=0.3, downsample_rate=1, imu_rate=200.0,
        real_time_delay=0.1, empty_lidar_time=0.5, degeneracy_threshold=0.0,
        covariance_acceleration=1e-2, covariance_gyroscope=1e-3, point_buckets=(1024,),
        ds_buckets=(1024,), imu_buckets=(32,), map_table_size=1 << 12, knn_rings=1,
        match_mode="rematch"), **kw})


def _pipeline_sim():
    return simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5),
                    interop.config_from_kwargs(_fields(_pipeline_config())), duration=0.9,
                    lidar_lines=8, pts_per_line=128, imu_rate=200.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 2-rank gloo world runs every port case; returns (the payloads by
    run name, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp, jc, _ = _example(map_table_size=1 << 10)
    inp_g, jc_g, _ = _example(map_table_size=1 << 11, knn_rings=1, knn_backend="pallas")
    pts, q = _ring_points()
    rng = np.random.default_rng(1)
    win = rng.normal(size=(64, 3)).astype(np.float32)
    pcfg = _fields(_pipeline_config())
    sim = _pipeline_sim()
    runs = dict(
        step_points=("step_points", dict(cfg=_fields(jc), inp=_inputs_dict(inp))),
        step_map=("step_map", dict(cfg=_fields(jc), inp=_inputs_dict(inp))),
        step_grouped=("step_points", dict(cfg=_fields(jc_g), inp=_inputs_dict(inp_g))),
        ring_knn=("ring_knn", dict(grid=RING_GRID, pts=pts, queries=q)),
        prune_sharded=("prune_sharded", dict(grid=RING_GRID, pts=pts,
                                             center=np.zeros(3, np.float32), radius=4.0)),
        posegraph=("posegraph", _pose_problem()),
        multihost=("multihost", dict(bucket=64, pts=win, t=np.arange(64, dtype=np.float32),
                                     mask=np.arange(64) < 50)),
        pipeline_points=("pipeline", dict(cfg=pcfg, sim=sim, shard="points", dir=str(tmp))),
        pipeline_map=("pipeline", dict(cfg=pcfg, sim=sim, shard="map", dir=str(tmp))),
    )
    results = mh.spawn(run_cases, D, args=(runs,), device="cpu", workdir=str(tmp),
                       timeout_s=WORLD_TIMEOUT_S)
    payloads = {name: payload for name, (_, payload) in runs.items()}
    return payloads, results


def _case(world, name):
    """Every rank's result of a case; fails with the rank's traceback."""
    results = [r[name] for r in world[1]]
    for r, res in enumerate(results):
        if isinstance(res, dict) and "error" in res:
            pytest.fail(f"rank {r}: {res['error']}")
    return results


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(jax.devices()[:D])


def _flips(ranks, name, out_j) -> int:
    """Medoid flips: downsampled rows whose window index differs from the
    JAX step's (a voxel whose two nearest points tie to within the f32
    rounding of the deskewed coordinates; at most 2 a step)."""
    idx = np.concatenate([r[name]["ds_idx"] for r in ranks])
    flips = int((idx != np.asarray(out_j.global_ds_idx)).sum())
    assert flips <= 2
    return flips


def _assert_step_matches(port, out_j, P_tol=1e-3):
    np.testing.assert_allclose(port["p"], np.asarray(out_j.x.p), atol=1e-5)
    np.testing.assert_allclose(port["R"], np.asarray(out_j.x.R), atol=1e-5)
    np.testing.assert_allclose(port["P"], np.asarray(out_j.P), atol=P_tol, rtol=P_tol)
    assert port["updated"] == bool(out_j.updated)
    assert port["ds_count"] == int(out_j.ds_count)
    assert port["num_matches"] == int(out_j.diag.num_matches)


def _assert_same_map_points(port_map: dict, j_map, flips: int = 0):
    """The same buckets in the same table rows, the same cells occupied and
    the stored points within 5e-5 m (world-frame placements of f32 states
    that agree to 1e-6), but for the cells of `flips` flipped medoids (each
    moves one point to another cell), which the counters may differ by."""
    np.testing.assert_array_equal(port_map["keys"], np.asarray(j_map.keys))
    occ_j = np.isfinite(np.asarray(j_map.cell_d2))
    occ_t = np.isfinite(port_map["cell_d2"])
    assert (occ_t != occ_j).sum() <= 2 * flips
    both = occ_t & occ_j
    close = np.abs(port_map["pts"][both] - np.asarray(j_map.pts)[both]).max(-1) < 5e-5
    assert (~close).sum() <= flips
    for k in ("num_points", "num_buckets", "dropped"):
        assert np.abs(port_map[k] - np.asarray(getattr(j_map, k))).max() <= flips, k


def test_point_sharded_step_matches_jax_and_single_device(world, jmesh):
    """Two chained point-sharded steps (the second localizes against the
    map the first built) against `make_sharded_step` on a 2-device mesh:
    p and R to 1e-5, P to 1e-3, the same update and match counts, the same
    map; the ranks hold the same replicated state; and against the port's
    single-device `lio_step`."""
    payload = world[0]["step_points"]
    ranks = _case(world, "step_points")
    inp, jc, grid = _example(map_table_size=1 << 10)
    step = j_make_sharded_step(jmesh, jc, grid)
    out1 = step(inp, j_make_map(grid))
    first = _np(out1)
    out2 = _np(step(inp, out1.map))
    flips = _flips(ranks, "first", first)
    flips += _flips(ranks, "second", out2)
    for r in ranks:
        _assert_step_matches(r["first"], first)
        _assert_step_matches(r["second"], out2)
        _assert_same_map_points(r["first"]["map"], first.map, flips)
        _assert_same_map_points(r["second"]["map"], out2.map, flips)
        np.testing.assert_array_equal(r["second"]["telemetry"], ranks[0]["second"]["telemetry"])
    assert ranks[0]["second"]["num_matches"] > 0
    # the window fields are the rank's rows; ds indices point into the window
    idx = np.concatenate([r["first"]["ds_idx"][r["first"]["ds_mask"]] for r in ranks])
    half = len(payload["inp"]["pts"]) // D
    assert idx[:ranks[0]["first"]["ds_mask"].sum()].max() < half <= idx.max()

    tc = interop.config_from_kwargs(payload["cfg"])
    tgrid = GridParams.from_config(tc)
    single = lio_step(port_inputs(payload["inp"], tc), make_map(tgrid, device="cpu"),
                      tc.static(), tgrid)
    np.testing.assert_allclose(ranks[0]["first"]["p"], single.x.p.numpy(), atol=1e-5)
    np.testing.assert_allclose(ranks[0]["first"]["R"], single.x.R.numpy(), atol=1e-5)
    assert ranks[0]["first"]["updated"] == bool(single.updated)
    n_single = int(single.map.num_points)
    # per-shard voxel dedup at the shard border (ROADMAP faults): the
    # sharded insert batch may hold a few more points than the single one
    assert abs(int(ranks[0]["first"]["map"]["num_points"]) - n_single) <= max(8, 0.02 * n_single)


def test_map_sharded_step_matches_jax(world, jmesh):
    """Two chained map-sharded steps against `make_map_sharded_step`: the
    same state (p, R 1e-5; P 1e-3) and counts, and each rank's map shard is
    the JAX sharded map's rows for that device (`interop.split_sharded_map`),
    bucket for bucket."""
    ranks = _case(world, "step_map")
    inp, jc, grid = _example(map_table_size=1 << 10)
    step = j_ms.make_map_sharded_step(jmesh, jc, grid)
    out1 = step(inp, j_ms.make_sharded_map(jmesh, grid))
    first = _np(out1)
    out2 = _np(step(inp, out1.map))
    flips = 0
    for name, j_out in (("first", first), ("second", out2)):
        flips += _flips(ranks, name, j_out)
        shards = interop.split_sharded_map(j_out.map._asdict(), D, "cpu")
        for r, res in enumerate(ranks):
            _assert_step_matches(res[name], j_out)
            _assert_same_map_points(res[name]["map"], interop.to_numpy(shards[r]),
                                    flips)
            # telemetry carries the counters summed over the ranks
            assert np.abs(res[name]["telemetry"][38:41]
                          - np.asarray(j_out.telemetry)[38:41]).max() <= flips
        joined = interop.join_sharded_maps([interop.map_from_numpy(res[name]["map"], "cpu")
                                            for res in ranks])
        _assert_same_map_points(joined, j_out.map, flips)
    assert ranks[0]["second"]["num_matches"] > 0


def test_grouped_backend_through_the_sharded_step(world, jmesh, monkeypatch):
    """The grouped KNN on the point-sharded step: the JAX package's Pallas
    kernel in interpret mode under `shard_map` against the port's plain
    version of the kernel on each rank (g_max taken per shard on both
    sides); on the CPU the port launches no kernel."""
    monkeypatch.setattr(pallas_knn, "knn_grouped",
                        functools.partial(pallas_knn.knn_grouped, interpret=True))
    ranks = _case(world, "step_grouped")
    inp, jc, grid = _example(map_table_size=1 << 11, knn_rings=1, knn_backend="pallas")
    step = j_make_sharded_step(jmesh, jc, grid)
    out1 = step(inp, j_make_map(grid))
    first = _np(out1)
    out2 = _np(step(inp, out1.map))
    for r in ranks:
        assert r["launches"] == 0
        _assert_step_matches(r["first"], first)
        _assert_step_matches(r["second"], out2)
    assert ranks[0]["second"]["num_matches"] > 0


def test_ring_knn_matches_unsharded(world):
    """The ring KNN over the two shards against the port's unsharded dense
    `knn` on the whole map: sorted valid d² to rtol 1e-5, equal valid
    counts; the shards hold the single map's points, each bucket on its
    owner."""
    pay = world[0]["ring_knn"]
    ranks = _case(world, "ring_knn")
    grid = GridParams(**RING_GRID)
    m = insert(make_map(grid, device="cpu"), torch.as_tensor(pay["pts"]),
               torch.ones(len(pay["pts"]), dtype=torch.bool), grid)
    assert sum(int(r["map"]["num_points"]) for r in ranks) == int(m.num_points)
    for rank, r in enumerate(ranks):
        assert (r["owners"] == rank).all()
    _, d2_ref, v_ref = knn(m, torch.as_tensor(pay["queries"]), grid, k=5, rings=1)
    d2 = np.concatenate([r["d2"] for r in ranks])
    valid = np.concatenate([r["valid"] for r in ranks])
    np.testing.assert_allclose(np.sort(np.where(valid, d2, np.inf), axis=1),
                               np.sort(np.where(v_ref.numpy(), d2_ref.numpy(), np.inf), axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(valid.sum(1), v_ref.numpy().sum(1))


def test_owner_of_matches_jax():
    rng = np.random.default_rng(2)
    coarse = np.concatenate([rng.integers(-2000, 2000, (4096, 3)),
                             [[-(2 ** 31) + 1] * 3, [2 ** 31 - 1] * 3, [0, 0, 0], [-1, -1, -1]]]
                            ).astype(np.int32)
    for d in (1, 2, 3, 8):
        np.testing.assert_array_equal(ms.owner_of(torch.as_tensor(coarse), d).numpy(),
                                      np.asarray(j_ms.owner_of(jnp.asarray(coarse), d)))


def test_insert_sharded_conserves_points(world):
    """Every point of the batch lands on exactly one rank: the shards' point
    and bucket counts sum to the single map's, and their tables hold the
    single map's points."""
    pay = world[0]["ring_knn"]
    ranks = _case(world, "ring_knn")
    grid = GridParams(**RING_GRID)
    m = insert(make_map(grid, device="cpu"), torch.as_tensor(pay["pts"]),
               torch.ones(len(pay["pts"]), dtype=torch.bool), grid)
    for k in ("num_points", "num_buckets"):
        assert sum(int(r["map"][k]) for r in ranks) == int(getattr(m, k))
    flat = lambda mm: np.sort(mm["pts"][np.isfinite(mm["cell_d2"])], axis=0)
    np.testing.assert_array_equal(np.sort(np.concatenate([r["map"]["pts"][np.isfinite(
        r["map"]["cell_d2"])] for r in ranks]), axis=0), flat(interop.to_numpy(m)._asdict()))


def test_prune_on_the_sharded_map_reproduces_the_jax_counters(world, jmesh):
    """ROADMAP fault: the JAX pipeline prunes the map-sharded map as one
    global array, so the points and buckets dropped on all devices are
    subtracted from each device's counters.  `prune_sharded` reproduces
    the counters; the tables are the JAX ones, row for row."""
    pay = world[0]["prune_sharded"]
    ranks = _case(world, "prune_sharded")
    grid = JGrid(**RING_GRID)
    lgrid = j_ms.local_grid(grid, D)
    ins = jax.jit(jax.shard_map(
        lambda m, p, k: j_ms.insert_sharded(m, p, k, lgrid, j_ms.AXIS), mesh=jmesh,
        in_specs=(j_ms.map_specs(), P(j_ms.AXIS), P(j_ms.AXIS)), out_specs=j_ms.map_specs(),
        check_vma=False))
    m = ins(j_ms.make_sharded_map(jmesh, grid), jnp.asarray(pay["pts"]),
            jnp.ones(len(pay["pts"]), bool))
    before = np.asarray(m.num_points).copy()
    pruned = _np(j_prune(m, jnp.asarray(pay["center"]), jnp.float32(pay["radius"]), grid))
    shards = interop.split_sharded_map(pruned._asdict(), D, "cpu")
    for r, res in enumerate(ranks):
        _assert_same_map_points(res, interop.to_numpy(shards[r]))
    # the fault itself: the summed counter fell D times the pruned points
    dropped = before.sum() - sum(np.isfinite(s.cell_d2.numpy()).sum() for s in shards)
    assert dropped > 0
    assert before.sum() - pruned.num_points.sum() == D * dropped


def test_sharded_pose_graph_matches_jax_and_single_device(world, jmesh):
    pay = world[0]["posegraph"]
    ranks = _case(world, "posegraph")
    jg, g = JPoseGraph(), PoseGraph()
    for e in zip(*pay["edges"]):
        jg.add_edge(*e)
        g.add_edge(*e)
    Rs_j, ps_j, costs_j = j_opt_sharded(jg, pay["Rs0"], pay["ps0"], jmesh, iters=pay["iters"])
    Rs_s, ps_s, _ = optimize_pose_graph(g, pay["Rs0"], pay["ps0"], iters=pay["iters"],
                                        device="cpu")
    for r in ranks:
        for want_R, want_p in ((Rs_j, ps_j), (Rs_s, ps_s)):
            np.testing.assert_allclose(r["ps"], want_p, atol=1e-4)
            np.testing.assert_allclose(r["Rs"], want_R, atol=1e-4)
        # the costs fall to ~1e-13: relative agreement only above 1e-6
        np.testing.assert_allclose(r["costs"], costs_j, rtol=1e-3, atol=1e-6)
        assert r["costs"][-1] < r["costs"][0]
    np.testing.assert_array_equal(ranks[0]["ps"], ranks[1]["ps"])


def test_init_distributed_is_a_no_op_without_environment(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_multihost_helpers_in_a_two_rank_world(world):
    """`window_from_local` places each rank's rows on its device and refuses
    unequal row counts on every rank; `replicate` places a tree;
    `local_point_budget` splits a bucket and refuses a ragged one."""
    pay = world[0]["multihost"]
    ranks = _case(world, "multihost")
    for rank, r in enumerate(ranks):
        assert r["n"] == 32
        rows = slice(32 * rank, 32 * (rank + 1))
        np.testing.assert_array_equal(r["pts"], pay["pts"][rows])
        np.testing.assert_array_equal(r["t"], pay["t"][rows])
        np.testing.assert_array_equal(r["mask"], pay["mask"][rows])
        np.testing.assert_array_equal(r["rep_a"], pay["pts"][:3])
        np.testing.assert_array_equal(r["rep_c"], pay["t"][:2])
        assert r["rep_b"] == 2.0
        assert "different row counts" in r["unequal"]
        assert "must divide" in r["ragged"]
        assert r["devices"] == ["cpu"] * 4
        assert r["mesh"] == dict(rank=rank, size=D, device="cpu", backend="gloo",
                                 host_staging=False)


@pytest.mark.parametrize("shard", ["points", "map"])
def test_pipeline_with_a_mesh_matches_jax(world, jmesh, shard):
    """`LioPipeline(mesh=..., shard=...)` against the JAX pipeline on a
    2-device mesh over 0.9 s of a room ("rematch" cadence, dense KNN): the
    same record times, positions within 5 mm, map sizes within the medoid
    flips; the
    gathered window on every rank; a checkpoint written by rank 0 loads
    back to the same map on each rank (the map-sharded file in the JAX
    layout, counters of shape (D,))."""
    ranks = _case(world, f"pipeline_{shard}")
    sim = world[0][f"pipeline_{shard}"]["sim"]
    jp = JLioPipeline(_pipeline_config(), mesh=jmesh, shard=shard, defer_readback=False)
    replay_into(jp, sim)
    jr = jp.result
    for r in ranks:
        assert len(r["times"]) == len(jr.records) >= 5
        np.testing.assert_array_equal(r["times"], jr.times)
        d = np.linalg.norm(r["positions"] - jr.positions, axis=1)
        assert d.max() < POS_TOL, d
        # medoid flips move a few points (tests/test_parallel.py's bound)
        n_j = np.array([rec.map_points for rec in jr.records])
        assert (np.abs(np.array(r["map_points"]) - n_j) <= np.maximum(8, 0.02 * n_j)).all()
        assert r["checkpoint_same_map"]
        assert r["checkpoint_counters"] == ((D,) if shard == "map" else ())
    np.testing.assert_array_equal(ranks[0]["positions"], ranks[1]["positions"])
    np.testing.assert_array_equal(ranks[0]["gpts"], ranks[1]["gpts"])
    np.testing.assert_array_equal(ranks[0]["gds"], ranks[1]["gds"])
    assert len(ranks[0]["gds"]) > 0
    if shard == "map":
        assert sum(r["local_buckets"] for r in ranks) == ranks[0]["map_buckets"][-1]
    ate, _ = ate_rmse(ranks[0]["times"], ranks[0]["positions"], sim.gt_t, sim.gt_R, sim.gt_p)
    assert ate < 0.05


def test_cli_devices_matches_jax(tmp_path, monkeypatch):
    """`sim --devices 2 --shard points --device cpu` (two spawned gloo
    ranks; rank 0 writes) against the JAX CLI's `--devices 2` on the same
    configuration: the same TUM record times, positions within 5 mm."""
    import yaml

    from limovelo_tpu.__main__ import main as jax_main
    from limovelo_tpu_torch.__main__ import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the spawned ranks' torch threads
    jc = _pipeline_config(point_buckets=(4096,), ds_buckets=(4096,))
    d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in jc.__dict__.items()
         if not k.startswith("_")}
    d["Initialization"] = {"times": list(jc.Initialization.times),
                           "deltas": list(jc.Initialization.deltas)}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(d))
    argv = ["sim", "--world", "room", "--duration", "1.0", "--config", str(cfg),
            "--devices", "2", "--shard", "points"]
    jax_main(argv + ["--out", str(tmp_path / "j.tum")])
    main(argv + ["--out", str(tmp_path / "t.tum"), "--device", "cpu"])
    tj, tt = (np.atleast_2d(np.loadtxt(tmp_path / f)) for f in ("j.tum", "t.tum"))
    assert len(tt) == len(tj) >= 5
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    assert np.linalg.norm(tt[:, 1:4] - tj[:, 1:4], axis=1).max() < POS_TOL
