"""The plain reference held against an independent witness, the JAX package.

The reference (`reference/lio/`) is a frozen copy of the program's plain
path, so the comparison that decides `correct` catches departures from that
copy: a regression oracle of the port, not a second implementation.  Here the
copy is held against the JAX package's `LioPipeline` (the grouped KNN through
its Pallas kernel, interpreted) on the CPU, over the same messages of a tiny
stretch of the benchmark's stream, decoded once by the reference's ingest.  The
benchmark's runs load no JAX; a test may.

The two sides round the deskew in another order, so a voxel's medoid or a
plane gate can flip on an f32 near-tie.  Until the first window whose
downsampled count or match count differs, the two agree to rounding; from
there the estimator, weakly held on this small scene, carries the flip on
as a slow drift (about 1.5 mm a window here), so later windows are held to
a drift bound.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from lio_bench.cells import build_config, make_stream
from lio_bench.reference.lio import config as ref_config
from lio_bench.reference.lio.runtime.pipeline import LioPipeline
from lio_bench.reference.replay import feed
from lio_bench.tests.tiny import tiny_cell

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

#: metres: before any flip, and over the whole stretch
EXACT_TOL = 1e-4
DRIFT_TOL = 0.02


def _witness_cell():
    """A stretch of the benchmark's generator on the scene of
    tests/test_torch_pipeline.py: the DEFAULT profile with the 1-ring grouped
    KNN, an 8 x 128 sensor, a 12 m room, a 2.5 m ring; one shape bucket
    each, so the JAX side compiles its step once."""
    cell = tiny_cell("kitti_hdl64.online")
    c = cell.config
    c["profile"] = "default"
    c["profile_overrides"] = {"knn_rings": 1, "knn_backend": "grouped",
                              "map_table_size": 1 << 12, "point_buckets": [1024],
                              "imu_buckets": [32]}
    c["sensor"].update(beams=8, azimuths=128, elevation_deg=[-15.0, 15.0], max_range_m=80.0)
    c["scene"].update(size_m=12.0, n_boxes=10)
    c["course"].update(radius_m=2.5, lap_s=12.6, hold_s=0.5, ramp_s=1.0)
    return cell


@pytest.fixture
def interpreted_pallas(monkeypatch):
    import limovelo_tpu.ops.pallas.knn as pallas_knn

    monkeypatch.setattr(pallas_knn, "knn_grouped",
                        functools.partial(pallas_knn.knn_grouped, interpret=True))


def _jax_config(cfg):
    from limovelo_tpu.config import Config, InitializationParams

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["knn_backend"] = "pallas"
    kw["Initialization"] = InitializationParams(times=tuple(cfg.Initialization.times),
                                                deltas=tuple(cfg.Initialization.deltas))
    return Config(**kw)


def test_reference_agrees_with_the_jax_package(interpreted_pallas):
    from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline

    torch.set_num_threads(1)
    cell = _witness_cell()
    cfg = build_config(ref_config, cell.config, cell.mix)
    assert cfg.static().knn_backend == "grouped"
    stream = make_stream(cell, 2 ** 31 + 77, "cpu")
    n = stream.ramp_messages
    spin_every_imu = bool(cell.config["feed"]["spin_every_imu"])

    ref = LioPipeline(cfg, device="cpu")
    with torch.no_grad():
        feed(ref, cfg, stream, 0, n, spin_every_imu)
    jp = JLioPipeline(_jax_config(cfg), defer_readback=False)
    feed(jp, cfg, stream, 0, n, spin_every_imu)
    rr, jr = ref.result, jp.result

    assert len(rr.records) == len(jr.records) >= 8
    assert ref.collapsed_windows == jp.collapsed_windows
    np.testing.assert_array_equal(rr.times, jr.times)
    # a flipped medoid moves a window's downsampled count by a point or two
    ds_r = np.array([r.ds_count for r in rr.records], float)
    ds_j = np.array([r.ds_count for r in jr.records], float)
    assert np.all(np.abs(ds_r - ds_j) <= 0.02 * ds_j), (ds_r, ds_j)
    d = np.linalg.norm(rr.positions - jr.positions, axis=1)
    flip = [a.ds_count != b.ds_count or a.num_matches != b.num_matches
            for a, b in zip(rr.records, jr.records)]
    first = flip.index(True) if any(flip) else len(flip)
    assert first >= 8, first
    assert d[:first].max() < EXACT_TOL, d[:first]
    assert d.max() < DRIFT_TOL, d
    # the update ran on matched planes before the first flip
    assert sum(r.num_matches for r in rr.records[:first]) > 0
