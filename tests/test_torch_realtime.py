"""Port parity of the real-time schedule: the XALOC profile (real-time
windows, online extrinsics, its Velodyne's offsets from the rotation start)
in its 100 Hz mode, a spin after every IMU sample, through the JAX
package's `LioPipeline` and the port's `LioPipeline(device="cpu")` on one
short seeded stream, and the census of the port's spin counters.

The stream is cut to what the CPU runs in about a minute, most of it the
JAX side's one compile of its step: 0.8 s of a 12 m room with ten boxes
seen by a 16 × 256 LiDAR on a 2.5 m circle, a warm-up of 0.1, 0.05 and
0.02 s windows over 0.3 s before the 10 ms windows, the profile's own KNN
envelope, a 4096-bucket table, one point, downsample and IMU bucket, and
`min_dist` 0.5 m as in the benchmark's xaloc_racing cell (the profile's
4 m would leave a room this small nearly empty).
"""

import dataclasses

import numpy as np
import pytest
import torch

from limovelo_tpu.config import XALOC as J_XALOC
from limovelo_tpu.config import InitializationParams as JInitializationParams
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
from limovelo_tpu_torch.runtime.evaluate import ate_rmse
from limovelo_tpu_torch.runtime.pipeline import LioPipeline

torch.set_num_threads(1)

#: until the first window whose downsampled or match count differs the two
#: sides agree to rounding (metres, and the same in radians for rotations,
#: m/s for velocities), lio_bench/tests/test_lio_bench_witness.py's bound
EXACT_TOL = 1e-4
#: from that window on, a voxel medoid or a plane gate that flipped on an
#: f32 near-tie (the two sides round the deskew in another order) has moved
#: the match set by a point or two, and the estimator carries the flip on:
#: positions and the extrinsic translation within the witness's drift bound
DRIFT_TOL = 0.02
#: ... orientations and the extrinsic rotation within the same bound over
#: the points' lever arms in this 12 m room (4 m)
DRIFT_ROT_DEG = float(np.degrees(DRIFT_TOL / 4.0))
#: ... and velocities within the same bound over a 0.1 s window
DRIFT_VEL = DRIFT_TOL / 0.1
#: the warm-up ends this long (data time) after the initial time
WARMUP_S = 0.3


def _angle_deg(Ra, Rb):
    """Angle of Raᵀ Rb, stable for small angles: ‖Ra − Rb‖_F = 2√2 sin(θ/2)."""
    fro = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2.0 * np.arcsin(min(fro / (2.0 * np.sqrt(2.0)), 1.0)))


def _extr_R(rec):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rec.extr_rotvec).as_matrix()


@pytest.fixture(scope="module")
def runs():
    jc = J_XALOC.replace(
        min_dist=0.5, map_table_size=1 << 12, point_buckets=(2048,), ds_buckets=(2048,), imu_buckets=(64,),
        Initialization=JInitializationParams(times=(0.1, 0.2, WARMUP_S),
                                             deltas=(0.1, 0.05, 0.02, 0.01)))
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    assert tc.real_time and tc.estimate_extrinsics and tc.offset_beginning
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5,
                                                                      ramp=0.5, hold=0.3),
                   tc, duration=0.8, lidar_lines=16, pts_per_line=256, imu_rate=tc.imu_rate)

    jp = JLioPipeline(jc, defer_readback=False)
    replay_into(jp, sim, spin_every_imu=True)
    tp = LioPipeline(tc, device="cpu")
    spins = [0]
    spin_once = tp.spin_once

    def counted():
        spins[0] += 1
        return spin_once()

    tp.spin_once = counted
    replay_into(tp, sim, spin_every_imu=True)
    return sim, jp, tp, spins[0]


def test_realtime_100hz_replay_matches_jax(runs):
    sim, jp, tp, _ = runs
    jr, tr = jp.result, tp.result
    assert len(tr.records) == len(jr.records) >= 30
    assert tp.collapsed_windows == jp.collapsed_windows == 0
    np.testing.assert_array_equal(tr.times, jr.times)
    # the windows shrink to 10 ms once the warm-up is over
    t0 = tp.accum.initial_time
    steady = tr.times[tr.times > t0 + WARMUP_S + 0.01]
    assert len(steady) >= 20
    np.testing.assert_allclose(np.diff(steady), 0.01, atol=1e-6)
    # a flipped medoid moves a window's downsampled count by a point or two
    ds_t = np.array([r.ds_count for r in tr.records], float)
    ds_j = np.array([r.ds_count for r in jr.records], float)
    assert np.all(np.abs(ds_t - ds_j) <= 0.02 * ds_j), (ds_t, ds_j)
    flip = [a.ds_count != b.ds_count or a.num_matches != b.num_matches
            for a, b in zip(tr.records, jr.records)]
    first = flip.index(True) if any(flip) else len(flip)
    # the first updates against the map, with the extrinsics estimated
    assert first >= 2 and tr.records[1].num_matches > 0, first
    for i, (a, b) in enumerate(zip(tr.records, jr.records)):
        pos, rot, vel = (EXACT_TOL, np.degrees(EXACT_TOL), EXACT_TOL) if i < first else (
            DRIFT_TOL, DRIFT_ROT_DEG, DRIFT_VEL)
        assert np.linalg.norm(a.p - b.p) < pos, (a.t, a.p, b.p)
        assert _angle_deg(a.R, b.R) < rot, a.t
        assert np.linalg.norm(a.v - b.v) < vel, (a.t, a.v, b.v)
        assert np.linalg.norm(a.extr_t - b.extr_t) < pos, (a.t, a.extr_t, b.extr_t)
        assert _angle_deg(_extr_R(a), _extr_R(b)) < rot, a.t
    # the extrinsics are estimated, not held
    assert any(np.linalg.norm(r.extr_t - np.asarray(tp.config.I_Translation_L)) > 1e-6
               for r in tr.records)
    ate_t, _ = ate_rmse(tr.times, tr.positions, sim.gt_t, sim.gt_R, sim.gt_p)
    ate_j, _ = ate_rmse(jr.times, jr.positions, sim.gt_t, sim.gt_R, sim.gt_p)
    assert abs(ate_t - ate_j) < DRIFT_TOL
    assert ate_t < 0.02


def test_spin_counters_census(runs):
    """Between two 10 ms windows a spin after each of four 400 Hz IMU
    samples: three find the window not yet full, the fourth processes it,
    and the spin loop's next pass finds nothing more; a scan's spin, one in
    ten windows, finds nothing either.  The closed loop skips no data time,
    and every window's delta is the 10 ms in force."""
    sim, _, tp, spins = runs
    c = tp.timers.counters
    windows = tp.timers.window
    assert windows == len(tp.result.records) == len(tp.timers.log)
    # every pass either processed a window or counted itself idle
    assert spins == c["pipeline.idle_spins"] + windows
    assert tp.timers.summary()["spin_idle"]["n"] == c["pipeline.idle_spins"]
    # the window log's marks at the close of the windows after the warm-up
    t = tp.result.times
    log = list(tp.timers.log)[-int((t > tp.accum.initial_time + WARMUP_S + 0.01).sum()):]
    grow = lambda k: np.diff([m.counters[k] for m in log])
    assert len(log) >= 20
    idle = grow("pipeline.idle_spins")
    assert set(idle) <= {4, 5}
    scans_between = int((idle == 5).sum())
    assert scans_between == pytest.approx(len(idle) / 10, abs=1)
    assert (grow("pipeline.delta_us") == 10_000).all()
    assert (grow("pipeline.skipped_us") == 0).all()
