"""The stream: a ramp, then one lap replayed; the seam is continuous and
laps shift by exactly the lap period."""

import numpy as np
import pytest
import torch

from lio_bench.cells import BENCH_DIR, load_benchmark, make_stream
from lio_bench.tests.tiny import tiny_cell
from lio_bench.traffic.stream import build

CONFIGS = [c["name"] for c in load_benchmark()["configs"]]


def _ring(name):
    import json

    return build(json.load(open(BENCH_DIR / "configs" / f"{name}.json"))["course"])


@pytest.mark.parametrize("name", CONFIGS)
def test_course_repeats_after_the_ramp(name):
    ring = _ring(name)
    t = ring.lap_start_s + np.array([0.0, 0.37, 1.91])
    for k in (1, 3):
        s = t + k * ring.lap_s
        assert np.allclose(ring.position(s), ring.position(t), atol=1e-9)
        assert np.allclose(ring.rotation(s), ring.rotation(t), atol=1e-9)
        assert np.allclose(ring.velocity(s), ring.velocity(t), atol=1e-6)
        assert np.allclose(ring.acceleration(s), ring.acceleration(t), atol=1e-3)
        assert np.allclose(ring.body_rate(s), ring.body_rate(t), atol=1e-6)
    # the ramp reaches the lap speed, from standing
    assert np.allclose(np.linalg.norm(ring.velocity(t), axis=1), ring.speed_mps, rtol=1e-6)
    assert np.allclose(ring.velocity(np.array([0.0, ring.hold_s * 0.5])), 0.0, atol=1e-9)


@pytest.fixture(scope="module")
def stream():
    return make_stream(tiny_cell("kitti_hdl64.online"), seed=2 ** 31 + 12345, device="cpu")


def test_laps_shift_by_exactly_the_period(stream):
    n0, n = stream.ramp_messages, stream.lap_messages
    for m in (0, 1, n // 2, n - 1):
        k0, a = stream.message(n0 + m)
        for k in (1, 4):
            kk, b = stream.message(n0 + k * n + m)
            assert kk == k0
            if k0 == "imu":
                assert b[0] - a[0] == pytest.approx(k * stream.lap_s, abs=1e-9)
                assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
            else:
                assert b[2] - a[2] == pytest.approx(k * stream.lap_s, abs=1e-9)
                for x, y in zip((a[0], a[1], a[3]), (b[0], b[1], b[3])):
                    assert np.array_equal(x, y)


def _imu(stream, lo, hi):
    rows = [stream.message(m)[1] for m in range(lo, hi) if stream.message(m)[0] == "imu"]
    return (np.array([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.stack([r[2] for r in rows]))


def test_seam_is_continuous_in_time_pose_and_imu(stream):
    """Across the ramp→lap seam and the lap→lap seam the IMU keeps its
    period, and its readings (specific force, rate: the pose's derivatives,
    with the same constant bias) step no more than inside a lap."""
    n0, n = stream.ramp_messages, stream.lap_messages
    period = stream.lap.imu_t[1] - stream.lap.imu_t[0]
    for seam in (n0, n0 + n, n0 + 2 * n):
        t, a, w = _imu(stream, seam - 40, seam + 40)
        assert np.allclose(np.diff(t), period, atol=1e-9)
        inside_t, inside_a, inside_w = _imu(stream, n0 + n // 2 - 40, n0 + n // 2 + 40)
        noise = 8 * 0.02
        assert np.abs(np.diff(a, axis=0)).max() < np.abs(np.diff(inside_a, axis=0)).max() + noise
        assert np.abs(np.diff(w, axis=0)).max() < np.abs(np.diff(inside_w, axis=0)).max() + noise
    # scans follow each other at the rotation period across both seams
    stamps = [stream.message(m)[1][2] for m in range(0, n0 + 2 * n)
              if stream.message(m)[0] == "scan"]
    assert np.allclose(np.diff(stamps), 0.1, atol=1e-6)


def test_the_seed_changes_the_noise_not_the_sizes():
    cell = tiny_cell("kitti_hdl64.online")
    a = make_stream(cell, seed=7, device="cpu")
    b = make_stream(cell, seed=7, device="cpu")
    c = make_stream(cell, seed=8, device="cpu")
    assert a.ramp_messages == c.ramp_messages and a.lap_messages == c.lap_messages
    assert [len(s.xyz) for s in a.lap.scans] == [len(s.xyz) for s in b.lap.scans]
    assert np.array_equal(a.lap.scans[3].xyz, b.lap.scans[3].xyz)
    assert not np.array_equal(a.lap.scans[3].xyz, c.lap.scans[3].xyz)
    assert abs(len(a.lap.scans[3].xyz) - len(c.lap.scans[3].xyz)) <= 2
    torch.testing.assert_close(torch.as_tensor(a.lap.imu_t), torch.as_tensor(c.lap.imu_t))
