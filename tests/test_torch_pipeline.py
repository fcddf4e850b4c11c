"""Port parity, end to end: one simulated room/circle stream through the JAX
package's `LioPipeline` (grouped KNN through its Pallas kernel, interpreted)
and through the port's `LioPipeline(device="cpu")` (the kernel's plain
version), in the same test.

Both pipelines resolve telemetry at depth 1 (the JAX one with
`defer_readback=False`), so their host bookkeeping sees the same values.
The stream is cut to a size the CPU runs in about two minutes, most of it
the interpreted Pallas kernel: 0.9 s of a 12 m room with ten boxes seen by
an 8 × 128 LiDAR on a 2.5 m circle, a 4096-bucket table, one point bucket
(1024) and one IMU bucket (32), so the JAX side compiles its step once.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import limovelo_tpu.ops.pallas.knn as pallas_knn
from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
from limovelo_tpu_torch.runtime.evaluate import ate_rmse
from limovelo_tpu_torch.runtime.pipeline import LioPipeline

torch.set_num_threads(1)

#: positions and ATE agree to 5 mm.  They differ at all because a voxel's
#: medoid or a plane gate flips on an f32 near-tie (the two sides round the
#: deskew in another order), which changes a window's match set by a few
#: points.  On this scene that moves the estimate by 1-2 mm; on scenes with
#: few matches per window the same flips move the two apart by centimetres,
#: so the scene is chosen to be well constrained.
POS_TOL = 0.005


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(pallas_knn, "knn_grouped",
                        functools.partial(pallas_knn.knn_grouped, interpret=True))


def test_pipeline_replay_matches_jax(interpreted_pallas):
    jc = J_DEFAULT.replace(knn_rings=1, knn_backend="pallas", map_table_size=1 << 12,
                           point_buckets=(1024,), imu_buckets=(32,))
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    assert tc.static().knn_backend == "grouped"
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), tc,
                   duration=0.9, lidar_lines=8, pts_per_line=128, imu_rate=200.0)

    jp = JLioPipeline(jc, defer_readback=False)
    replay_into(jp, sim)
    jr = jp.result

    tp = LioPipeline(tc, device="cpu")
    replay_into(tp, sim)
    tr = tp.result
    assert tp.timers.counters["knn_grouped.launches"] == 0   # the CPU runs the plain version

    assert len(tr.records) == len(jr.records) >= 6
    assert tp.collapsed_windows == jp.collapsed_windows
    np.testing.assert_array_equal(tr.times, jr.times)
    d = np.linalg.norm(tr.positions - jr.positions, axis=1)
    assert d.max() < POS_TOL, d
    assert np.all([r.num_matches > 0 for r in tr.records[1:]])
    ate_t, _ = ate_rmse(tr.times, tr.positions, sim.gt_t, sim.gt_R, sim.gt_p)
    ate_j, _ = ate_rmse(jr.times, jr.positions, sim.gt_t, sim.gt_R, sim.gt_p)
    assert abs(ate_t - ate_j) < POS_TOL
    assert ate_t < 0.05
