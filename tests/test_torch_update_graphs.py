"""The iterated update's graphed stretches (`limovelo_tpu_torch/filter/graphs.py`)
on the CPU: the key that decides when to record again, and the runner's
static buffers, with the recording emulated (a "replay" runs the stretch
again into the buffers, reading and writing them as a CUDA graph does),
against the eager update bit for bit.  The CPU pipeline and a mesh keep the
eager path.  The CUDA graphs themselves are checked on the card
(`tests/test_torch_cuda.py`, marker `cuda`)."""

import pytest
import torch

from limovelo_tpu_torch.config import DynParams
from limovelo_tpu_torch.filter import graphs
from limovelo_tpu_torch.filter import update as upd
from limovelo_tpu_torch.runtime import profiling

import update_cases as uc

torch.set_num_threads(1)


class _Emulated(graphs.Graphed):
    """Records nothing: a replay writes the stretch's results into the
    buffers again."""

    def _record(self, stretch, args):
        return lambda: self._write(stretch, args)


class _EmulatedGraphs(graphs.UpdateGraphs):
    runner = _Emulated


@pytest.fixture
def rec(monkeypatch):
    r = profiling.StageTimers()
    monkeypatch.setattr(profiling, "_current", r)
    return r


def _update(cfg, m, grid, window, graphs_=None):
    x0, P, pts, mask = window
    return upd.iterated_update(x0, P, m, pts, mask, grid, cfg.static(), cfg.dynamic(),
                               graphs=graphs_)


def test_graph_key_holds_every_part_a_recording_bakes_in():
    cfg = uc.update_config()
    sc, dyn = cfg.static(), cfg.dynamic()
    base = graphs.graph_key(2048, sc, dyn)
    hash(base)
    split = {
        "bucket": graphs.graph_key(4096, sc, dyn),
        "NUM_MATCH_POINTS": graphs.graph_key(2048, sc._replace(NUM_MATCH_POINTS=4), dyn),
        "match_mode": graphs.graph_key(2048, sc._replace(match_mode="freeze"), dyn),
        "estimate_extrinsics": graphs.graph_key(
            2048, sc._replace(estimate_extrinsics=not sc.estimate_extrinsics), dyn),
        "compute_degeneracy": graphs.graph_key(
            2048, sc._replace(compute_degeneracy=not sc.compute_degeneracy), dyn),
        "solve_dtype": graphs.graph_key(2048, sc._replace(solve_dtype="f32"), dyn),
    }
    for f in DynParams._fields:
        val = getattr(dyn, f)
        other = dyn._replace(**{f: val + 1 if isinstance(val, int) else 2 * val + 1.0})
        split[f"DynParams.{f}"] = graphs.graph_key(2048, sc, other)
    for part, key in split.items():
        assert key != base, part
    # what only the eager searches and the host loop read leaves it alone
    for f, val in (("MAX_NUM_ITERS", 5), ("mapping_online", not sc.mapping_online),
                   ("knn_rings", 2), ("knn_max_buckets", 32), ("knn_backend", "grouped")):
        assert graphs.graph_key(2048, sc._replace(**{f: val}), dyn) == base, f


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("mode", ["auto", "freeze", "rematch"])
def test_graphed_buffers_reproduce_the_eager_update(rec, mode, ext):
    """Five windows through one cache, the refresh firing in every other
    one: each equals the eager update bit for bit (no buffer carries a
    stale value between stretches or windows); the first window records
    every stretch, later ones replay them and record nothing; the results
    are fresh tensors, which later windows leave alone."""
    cfg = uc.update_config(match_mode=mode, estimate_extrinsics=ext)
    m, grid = uc.room_map(cfg, "cpu")
    cache = _EmulatedGraphs("cpu")
    c = rec.counters
    for w in range(5):
        offset = 0.06 if w % 2 == 0 else 0.001
        window = uc.update_window(cfg, 512, seed=w, device="cpu", offset=offset)
        searches = c["update.searches"]
        want = _update(cfg, m, grid, window)
        eager_searches = c["update.searches"] - searches
        cap, rep = c["update.graph_captures"], c["update.graph_replays"]
        got = _update(cfg, m, grid, window, cache)
        uc.assert_updates_equal(got, want)
        if w == 0:
            first = (got, want)
        assert c["update.searches"] - searches == 2 * eager_searches
        if mode == "auto":
            assert (eager_searches > 1) == (offset > 0.05), (w, eager_searches)
        if w == 0:
            assert c["update.graph_captures"] - cap == uc.CAPTURES[mode]
            assert c["update.graph_replays"] - rep == uc.REPLAYS[mode] - uc.CAPTURES[mode]
        else:
            assert c["update.graph_captures"] == cap
            assert c["update.graph_replays"] - rep == uc.REPLAYS[mode]
    uc.assert_updates_equal(*first)
    assert int(want[2].num_matches) > 200
    assert len(cache.by_key) == 1


def test_a_new_bucket_or_new_params_record_again(rec):
    """A key records once: a new point bucket and new `DynParams` each
    record every stretch anew, into buffers of their own; a key met before
    replays."""
    cfg = uc.update_config()
    m, grid = uc.room_map(cfg, "cpu")
    cache = _EmulatedGraphs("cpu")
    c = rec.counters
    runs = [(cfg, 512), (cfg, 1024), (cfg.replace(huber_delta=0.05), 512), (cfg, 512)]
    for i, (cf, bucket) in enumerate(runs):
        window = uc.update_window(cf, bucket, seed=10 + i, device="cpu")
        cap = c["update.graph_captures"]
        uc.assert_updates_equal(_update(cf, m, grid, window, cache), _update(cf, m, grid, window))
        assert c["update.graph_captures"] - cap == (uc.CAPTURES["auto"] if i < 3 else 0), i
    assert len(cache.by_key) == 3


def test_a_buffer_takes_no_other_shape_or_dtype():
    g = _Emulated(lambda: None)
    g.put(a=torch.zeros(3))
    buf = g.v.a
    g.put(a=torch.ones(3))
    assert g.v.a is buf and torch.equal(buf, torch.ones(3))
    for bad in (torch.ones(1), torch.ones(3, dtype=torch.float64)):
        with pytest.raises(ValueError):
            g.put(a=bad)


def test_the_cpu_pipeline_and_a_mesh_keep_the_eager_path(rec):
    """No graphs on the CPU (the pipeline builds none, so a CPU update
    counts no replay), and the update refuses graphs with a mesh."""
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    cfg = uc.update_config()
    m, grid = uc.room_map(cfg, "cpu")
    window = uc.update_window(cfg, 512, seed=3, device="cpu")
    _update(cfg, m, grid, window)
    assert rec.counters["update.searches"] > 0
    assert rec.counters["update.graph_replays"] == rec.counters["update.graph_captures"] == 0
    x0, P, pts, mask = window
    with pytest.raises(ValueError):
        upd.iterated_update(x0, P, m, pts, mask, grid, cfg.static(), cfg.dynamic(),
                            mesh=object(), graphs=_EmulatedGraphs("cpu"))
    assert LioPipeline(cfg, device="cpu")._update_graphs is None


def test_a_pipeline_hands_its_graphs_down_to_the_update(rec):
    """`LioPipeline` passes its cache through `StepInputs.graphs` and
    `lio_step` to the update: with the emulated recordings every window
    past the first replays, none records again, and the records equal an
    eager pipeline's exactly."""
    import numpy as np

    from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    cfg = uc.update_config(point_buckets=(1024,), imu_buckets=(32,), map_table_size=1 << 12,
                           real_time=False, real_time_delay=0.1, imu_rate=200.0)
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), cfg,
                   duration=0.9, lidar_lines=8, pts_per_line=128, imu_rate=200.0)
    eager = LioPipeline(cfg, device="cpu")
    replay_into(eager, sim)
    graphed = LioPipeline(cfg, device="cpu")
    graphed._update_graphs = _EmulatedGraphs("cpu")
    replay_into(graphed, sim)
    log = graphed.timers.log
    captures = np.diff([0] + [m.counters.get("update.graph_captures", 0) for m in log])
    replays = np.diff([0] + [m.counters.get("update.graph_replays", 0) for m in log])
    assert len(log) >= 4 and list(captures) == [uc.CAPTURES["auto"]] + [0] * (len(log) - 1)
    assert (replays[1:] == uc.REPLAYS["auto"]).all()
    assert eager.timers.counters["update.graph_replays"] == 0
    np.testing.assert_array_equal(graphed.result.positions, eager.result.positions)
    np.testing.assert_array_equal(graphed.result.times, eager.result.times)
