"""Rank-side cases of tests/test_torch_parallel.py: run inside the ranks that
`limovelo_tpu_torch.parallel.multihost.spawn` starts, on the CPU with gloo.

This module imports torch, numpy and the port only (never JAX nor a test
module), so that a spawned rank imports nothing else.  `run_cases` runs
the cases in one world and returns, per run, its numpy results or the
traceback of its failure, so that one failing case fails only its test.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from limovelo_tpu_torch import interop
from limovelo_tpu_torch.config import DynParams
from limovelo_tpu_torch.filter.process import ImuWindow, process_noise_Q
from limovelo_tpu_torch.mapping.hashgrid import GridParams, HashGridMap, make_map
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.step import StepInputs


def _launches() -> int:
    """Grouped-kernel launches counted by the rank's current recorder."""
    return profiling.current().counters["knn_grouped.launches"]


def port_inputs(inp: dict, cfg, device="cpu") -> StepInputs:
    """The JAX example's StepInputs, given as a dict of numpy fields (the
    states and IMU windows as dicts), as the port's StepInputs."""
    T = lambda a: torch.as_tensor(np.array(a)).to(device)
    st = lambda x: interop.state_from_numpy(x, device)
    imu = lambda w: ImuWindow(*(T(w[k]) for k in ("t", "a", "w", "mask")))
    return StepInputs(
        anchor=st(inp["anchor"]), anchor_t=T(inp["anchor_t"]), anchor_a=T(inp["anchor_a"]),
        anchor_w=T(inp["anchor_w"]), x=st(inp["x"]), P=T(inp["P"]),
        t_integrated=T(inp["t_integrated"]), imus_filter=imu(inp["imus_filter"]),
        imus_path=imu(inp["imus_path"]), pts=T(inp["pts"]), pts_t=T(inp["pts_t"]),
        pts_mask=T(inp["pts_mask"]), t2=T(inp["t2"]),
        Q=process_noise_Q(cfg, device=device), dyn=DynParams.from_config(cfg))


def example_inputs(cfg, n_pts: int, n_imu: int, device, pts=None) -> StepInputs:
    """`__graft_entry__._make_example`'s window built by the port itself
    (the same numpy draws), for machines without JAX; `pts` replaces its
    uniform points."""
    from limovelo_tpu_torch.geometry import state as st

    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(a).to(device)
    x = st.make_initial(cfg, device=device)
    g = np.array(cfg.gravity_vec, np.float32)
    ts = ((np.arange(n_imu) + 1) / (n_imu / 0.1)).astype(np.float32)
    imus = ImuWindow(t=T(ts), a=T(rng.normal(size=(n_imu, 3)).astype(np.float32) * 0.1 - g),
                     w=T(rng.normal(size=(n_imu, 3)).astype(np.float32) * 0.05),
                     mask=T(np.ones(n_imu, bool)))
    drawn = rng.uniform(-10, 10, size=(n_pts, 3)).astype(np.float32)
    pts = drawn if pts is None else np.asarray(pts, np.float32)
    return StepInputs(
        anchor=x, anchor_t=T(np.float32(0.0)), anchor_a=T(-g), anchor_w=T(np.zeros(3, np.float32)),
        x=x, P=st.initial_covariance(device=device), t_integrated=T(np.float32(0.0)),
        imus_filter=imus, imus_path=imus, pts=T(pts),
        pts_t=T(rng.uniform(0, 0.1, n_pts).astype(np.float32)), pts_mask=T(np.ones(n_pts, bool)),
        t2=T(np.float32(0.1)), Q=process_noise_Q(cfg, device=device),
        dyn=DynParams.from_config(cfg))


def _local_rows(mesh, inp: StepInputs) -> StepInputs:
    from limovelo_tpu_torch.parallel.sharding import shard_rows

    rows = shard_rows(mesh, inp.pts.shape[0])
    return inp._replace(pts=inp.pts[rows], pts_t=inp.pts_t[rows], pts_mask=inp.pts_mask[rows])


def _np_map(m: HashGridMap) -> dict:
    """Copies: the next step writes the map's tables in place."""
    return {k: v.numpy().copy() for k, v in m._asdict().items()}


def _step_out(out) -> dict:
    return dict(p=out.x.p.numpy(), R=out.x.R.numpy(), P=out.P.numpy(),
                updated=bool(out.updated), ds_count=int(out.ds_count),
                num_matches=int(out.diag.num_matches), telemetry=out.telemetry.numpy(),
                ds_idx=out.global_ds_idx.numpy(), ds_mask=out.global_ds_mask.numpy(),
                map=_np_map(out.map))


def case_step_points(mesh, p):
    from limovelo_tpu_torch.parallel.sharding import make_sharded_step

    cfg = interop.config_from_kwargs(p["cfg"])
    grid = GridParams.from_config(cfg)
    step = make_sharded_step(mesh, cfg, grid)
    inp = _local_rows(mesh, port_inputs(p["inp"], cfg))
    counters = profiling.current().counters
    launches, collectives = _launches(), counters["mesh.collectives"]
    out1 = step(inp, make_map(grid, device="cpu"))
    r1 = _step_out(out1)
    out2 = step(inp, out1.map)
    return dict(first=r1, second=_step_out(out2), launches=_launches() - launches,
                collectives=counters["mesh.collectives"] - collectives)


def case_step_map(mesh, p):
    from limovelo_tpu_torch.parallel import map_sharding as ms

    cfg = interop.config_from_kwargs(p["cfg"])
    grid = GridParams.from_config(cfg)
    step = ms.make_map_sharded_step(mesh, cfg, grid)
    inp = _local_rows(mesh, port_inputs(p["inp"], cfg))
    out1 = step(inp, ms.make_sharded_map(mesh, grid))
    r1 = _step_out(out1)
    out2 = step(inp, out1.map)
    return dict(first=r1, second=_step_out(out2))


def case_ring_knn(mesh, p):
    """Insert the points through `insert_sharded` (each rank passes its
    block of rows), then query each rank's block of queries."""
    from limovelo_tpu_torch.parallel import map_sharding as ms
    from limovelo_tpu_torch.parallel.sharding import shard_rows

    grid = GridParams(**p["grid"])
    lgrid = ms.local_grid(grid, mesh.size)
    pts, q = torch.as_tensor(p["pts"]), torch.as_tensor(p["queries"])
    rows = shard_rows(mesh, len(pts))
    m = ms.insert_sharded(ms.make_sharded_map(mesh, grid), pts[rows],
                          torch.ones(rows.stop - rows.start, dtype=torch.bool), lgrid, mesh)
    nb, d2, valid = ms.ring_knn(m, q[shard_rows(mesh, len(q))], lgrid, mesh, k=5, rings=1)
    owners = ms.owner_of(m.keys[(m.keys != -(2 ** 31)).all(-1)], mesh.size)
    return dict(nb=nb.numpy(), d2=d2.numpy(), valid=valid.numpy(), map=_np_map(m),
                owners=owners.numpy())


def case_prune_sharded(mesh, p):
    """The sharded map after one insert and one `prune_sharded`."""
    from limovelo_tpu_torch.parallel import map_sharding as ms
    from limovelo_tpu_torch.parallel.sharding import shard_rows

    grid = GridParams(**p["grid"])
    lgrid = ms.local_grid(grid, mesh.size)
    pts = torch.as_tensor(p["pts"])
    rows = shard_rows(mesh, len(pts))
    m = ms.insert_sharded(ms.make_sharded_map(mesh, grid), pts[rows],
                          torch.ones(rows.stop - rows.start, dtype=torch.bool), lgrid, mesh)
    m = ms.prune_sharded(m, torch.as_tensor(p["center"]), p["radius"], lgrid, mesh)
    return _np_map(m)


def case_posegraph(mesh, p):
    from limovelo_tpu_torch.graph import PoseGraph, optimize_pose_graph_sharded

    g = PoseGraph()
    for i, j, R, t, w in zip(*p["edges"]):
        g.add_edge(i, j, R, t, w)
    Rs, ps, costs = optimize_pose_graph_sharded(g, p["Rs0"], p["ps0"], mesh, iters=p["iters"])
    return dict(Rs=Rs, ps=ps, costs=costs)


def case_multihost(mesh, p):
    from limovelo_tpu_torch.parallel import multihost as mh

    n = mh.local_point_budget(mesh, p["bucket"])
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    gp, gt, gm = mh.window_from_local(mesh, p["pts"][rows], p["t"][rows], p["mask"][rows])
    rep = mh.replicate(mesh, {"a": p["pts"][:3], "b": (np.float32(2.0), [p["t"][:2]])})
    try:
        mh.window_from_local(mesh, p["pts"][:n + mesh.rank], p["t"][:n + mesh.rank],
                             p["mask"][:n + mesh.rank])
        unequal = "accepted"
    except ValueError as e:
        unequal = str(e)
    try:
        mh.local_point_budget(mesh, p["bucket"] + 1)
        ragged = "accepted"
    except ValueError as e:
        ragged = str(e)
    return dict(n=n, pts=gp.numpy(), t=gt.numpy(), mask=gm.numpy(), rep_a=rep["a"].numpy(),
                rep_b=float(rep["b"][0]), rep_c=rep["b"][1][0].numpy(), unequal=unequal,
                ragged=ragged, devices=[str(v.device) for v in (gp, gt, gm, rep["a"])],
                mesh=mesh.describe())


def case_pipeline(mesh, p):
    """`LioPipeline(mesh=..., shard=...)` over the stream; the records, a
    checkpoint round trip of the map and the gathered window."""
    import os

    from limovelo_tpu_torch.io.simulate import replay_into
    from limovelo_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    cfg = interop.config_from_kwargs(p["cfg"])
    pipe = LioPipeline(cfg, mesh=mesh, shard=p["shard"])
    replay_into(pipe, p["sim"])
    res = pipe.result
    path = os.path.join(p["dir"], f"ck_{p['shard']}.npz")
    save_checkpoint(path, pipe)
    mesh.psum(torch.zeros(1))             # rank 0 has written the file
    back = LioPipeline(cfg, mesh=mesh, shard=p["shard"])
    load_checkpoint(path, back)
    same_map = all(torch.equal(a, b) for a, b in zip(pipe.map, back.map))
    counters = np.load(path)["map_num_points"].shape
    return dict(times=res.times, positions=res.positions,
                map_points=[r.map_points for r in res.records],
                map_buckets=[r.map_buckets for r in res.records],
                local_buckets=int(pipe.map.num_buckets), gpts=pipe._last_gpts,
                gds=pipe._last_gds, checkpoint_same_map=same_map, checkpoint_counters=counters,
                update_graphs=pipe._update_graphs is not None,
                graph_replays=pipe.timers.counters["update.graph_replays"])


def case_card_step(mesh, p):
    """Two chained point-sharded steps on the card (the grouped backend):
    the state and this rank's grouped-kernel launches per step."""
    from limovelo_tpu_torch.parallel.sharding import make_sharded_step

    cfg = p["cfg"]
    grid = GridParams.from_config(cfg)
    step = make_sharded_step(mesh, cfg, grid)
    inp = _local_rows(mesh, example_inputs(cfg, p["n_pts"], p["n_imu"], mesh.device, p["pts"]))
    m, out, launches = make_map(grid, device=mesh.device), [], []
    for _ in range(2):
        before = _launches()
        o = step(inp, m)
        launches.append(_launches() - before)
        out.append(dict(p=o.x.p.cpu().numpy(), R=o.x.R.cpu().numpy(),
                        num_matches=int(o.diag.num_matches), device=str(o.x.p.device)))
        m = o.map
    return dict(steps=out, launches=launches, mesh=mesh.describe())


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_cases(mesh, runs: dict) -> dict:
    """Run each of `runs` (name → (case, payload)); per name the case's
    result, or {"error": traceback}.  Every rank runs the same cases in the
    same order, so their collectives pair up."""
    torch.set_num_threads(1)
    out = {}
    for name, (case, payload) in runs.items():
        try:
            out[name] = CASES[case](mesh, payload)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out
