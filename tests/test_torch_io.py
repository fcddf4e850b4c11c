"""Port parity of the I/O layer: the simulator, the replay, vendor decode, the
native ingest, the fixture writers and the dataset readers, each against the
JAX package's counterpart on the same inputs.  No pipeline runs here."""

import filecmp
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import limovelo_tpu.io.fixtures as jfx
import limovelo_tpu.io.kitti as jkitti
import limovelo_tpu.io.rosbag as jbag
import limovelo_tpu.io.simulate as jsim
import limovelo_tpu.native as jnative
from limovelo_tpu.config import DEFAULT as J_DEFAULT, KITTI as J_KITTI, Config as JConfig
from limovelo_tpu.io.pointcloud import decode_scan as j_decode_scan
from limovelo_tpu_torch import native
from limovelo_tpu_torch.config import DEFAULT, KITTI, Config
from limovelo_tpu_torch.io import fixtures as fx
from limovelo_tpu_torch.io import kitti, rosbag
from limovelo_tpu_torch.io import simulate as sim_mod
from limovelo_tpu_torch.io.pointcloud import decode_scan

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# simulator and replay
# ---------------------------------------------------------------------------

def _assert_same_streams(a, b):
    """Scan and return counts, times and IMU samples equal; points and
    intensities equal (each render batches the products of a whole scan,
    which may round differently from one column at a time: one f32 ulp is
    allowed)."""
    assert len(a.scans) == len(b.scans) > 0
    for sa, sb in zip(a.scans, b.scans):
        assert sa.stamp == sb.stamp
        assert sa.pts.shape == sb.pts.shape and sa.pts.dtype == sb.pts.dtype == np.float32
        np.testing.assert_array_equal(sa.t, sb.t)
        np.testing.assert_array_max_ulp(sa.pts, sb.pts, maxulp=1)
        np.testing.assert_array_max_ulp(sa.intensity, sb.intensity, maxulp=1)
    for k in ("imu_t", "imu_a", "imu_w", "gt_t", "gt_R", "gt_p"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


_SIM_CASES = {
    "room": lambda m: dict(world=m.room_world(size=24, n_boxes=10),
                           traj=m.circle_trajectory(radius=4, omega=0.5), config="default",
                           duration=0.3, lidar_lines=16, pts_per_line=360, imu_rate=400.0),
    "corridor": lambda m: dict(world=m.corridor_world(length=120.0, width=8.0, pillar_every=6.0),
                               traj=m.corridor_trajectory(speed=8.0), config="default",
                               duration=0.3, lidar_lines=16, pts_per_line=360, seed=13,
                               max_range=40.0),
    "kitti_azimuths": lambda m: dict(world=m.corridor_world(length=60.0),
                                     traj=m.corridor_trajectory(speed=4.0), config="kitti",
                                     duration=0.3, lidar_lines=12, pts_per_line=200, seed=5,
                                     t_start=1316000000.0,
                                     azimuths=jfx.kitti_azimuths(200)),
    "extrinsics": lambda m: dict(world=m.room_world(size=16, n_boxes=6),
                                 traj=m.circle_trajectory(radius=3, omega=0.4, sway=0.05),
                                 config="default", duration=0.3, lidar_lines=8,
                                 pts_per_line=256,
                                 extrinsics=(np.eye(3)[[1, 0, 2]] * [1, 1, -1],
                                             np.array([0.3, -0.1, 0.2]))),
}


@pytest.mark.parametrize("case", sorted(_SIM_CASES))
def test_simulate_matches_jax(case):
    """The port's simulator renders each scan's rays in one cast and draws
    its range noise at once; the streams stay the JAX simulator's."""
    configs = {"default": (J_DEFAULT, DEFAULT), "kitti": (J_KITTI, KITTI)}
    kw_j, kw_t = _SIM_CASES[case](jsim), _SIM_CASES[case](sim_mod)
    cfg_j, cfg_t = configs[kw_j.pop("config")]
    kw_t.pop("config")
    a = jsim.simulate(kw_j.pop("world"), kw_j.pop("traj"), cfg_j, **kw_j)
    b = sim_mod.simulate(kw_t.pop("world"), kw_t.pop("traj"), cfg_t, **kw_t)
    _assert_same_streams(a, b)


class _CallLog:
    """A stand-in pipeline that records the calls a replay makes."""

    def __init__(self):
        self.calls = []

    def add_imu(self, t, a, w, q=None):
        self.calls.append(("imu", float(t), tuple(np.asarray(a).tolist())))

    def add_scan(self, pts, t, intensity=None):
        self.calls.append(("scan", len(pts), float(t[-1])))

    def spin(self):
        self.calls.append(("spin",))


@pytest.fixture(scope="module")
def small_sim():
    return sim_mod.simulate(sim_mod.room_world(size=16, n_boxes=6),
                            sim_mod.circle_trajectory(radius=3, omega=0.4), DEFAULT,
                            duration=0.6, lidar_lines=6, pts_per_line=64, imu_rate=200.0, seed=3)


@pytest.mark.parametrize("spin_every_imu", [False, True])
def test_replay_into_makes_the_jax_calls(small_sim, spin_every_imu):
    """`replay_into` makes the JAX replay's call sequence, with and without
    a spin after every IMU sample, and two replays split at a scan make the
    calls of one."""
    want, got, split = _CallLog(), _CallLog(), _CallLog()
    jsim.replay_into(want, small_sim, spin_every_imu=spin_every_imu)
    sim_mod.replay_into(got, small_sim, spin_every_imu=spin_every_imu)
    assert got.calls == want.calls
    assert sum(c[0] == "spin" for c in got.calls) > (len(small_sim.imu_t) if spin_every_imu
                                                      else len(small_sim.scans))
    sim_mod.replay_into(split, small_sim, 0, 3, spin_every_imu=spin_every_imu)
    sim_mod.replay_into(split, small_sim, 3, spin_every_imu=spin_every_imu)
    assert split.calls == want.calls


# ---------------------------------------------------------------------------
# vendor decode and the native ingest
# ---------------------------------------------------------------------------

def _decode_case(name, rng):
    """(config kwargs, xyz, header stamp, time field, intensity) for one
    vendor path."""
    n = 300
    xyz = (rng.normal(size=(n, 3)) * 8).astype(np.float32)
    xyz[::17] = np.nan                           # non-finite returns are dropped
    inten = rng.uniform(0, 100, n).astype(np.float32)
    base = dict(min_dist=1.5, downsample_rate=1, full_rotation_time=0.1)
    t_true = 1234.5 + np.sort(rng.uniform(0.0, 0.095, n))
    t_true[0] = 1234.5
    if name.startswith("velodyne"):
        stamp_b, off_b = name == "velodyne_sb_ob" or name == "velodyne_sb_oe", name.endswith("ob")
        rel = (t_true - 1234.5).astype(np.float32)
        if not off_b:
            rel = rel - 0.1
        stamp = 1234.5 if stamp_b else 1234.5 + float(rel[-1] - rel[0])
        return (dict(base, LiDAR_type="velodyne", stamp_beginning=stamp_b,
                     offset_beginning=off_b), xyz, stamp, rel, None)
    if name == "ouster":
        return (dict(base, LiDAR_type="ouster", stamp_beginning=False, offset_beginning=False),
                xyz, 42.0, np.linspace(0, 1e8, n), inten)
    if name in ("hesai", "custom"):
        return dict(base, LiDAR_type=name, downsample_rate=4), xyz, 999.0, t_true, inten
    if name == "intensity":
        return (dict(base, LiDAR_type="velodyne", min_dist=4.0, downsample_rate=3), xyz, 10.0,
                rng.uniform(0, 0.1, n).astype(np.float32), inten)
    assert name == "missing_time"
    return dict(base, LiDAR_type="velodyne"), xyz, 100.0, None, None


@pytest.mark.parametrize("case", ["velodyne_sb_ob", "velodyne_sb_oe", "velodyne_se_ob",
                                  "velodyne_se_oe", "ouster", "hesai", "custom", "intensity",
                                  "missing_time"])
def test_decode_scan_matches_jax(case):
    """Every vendor path, all four velodyne stamp semantics, the intensity
    channel and the missing-time case: bit-equal to the JAX decode."""
    kw, xyz, stamp, tf, inten = _decode_case(case, np.random.default_rng(len(case)))
    got = decode_scan(Config(**kw), xyz, stamp, time_field=tf, intensity=inten)
    want = j_decode_scan(JConfig(**kw), xyz, stamp, time_field=tf, intensity=inten)
    assert len(got) == len(want) == (2 if inten is None else 3)
    assert 0 < len(got[0]) < len(xyz)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case == "missing_time":
        assert not got[1].any()


def test_native_process_scan_matches_plain_and_jax():
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(5000, 3)) * 10).astype(np.float32)
    xyz[::97, 1] = np.inf
    t = rng.uniform(0, 0.1, 5000)
    t[100:200] = 0.05                            # ties: the sort is stable
    inten = rng.uniform(0, 1, 5000).astype(np.float32)
    for rate, md in ((1, 0.0), (4, 3.0), (7, 12.0)):
        for extra in ((), (inten,)):
            got = native.process_scan(xyz, t, rate, md, *extra)
            plain = native.process_scan_plain(xyz, t, rate, md, *extra)
            want = jnative.process_scan(xyz, t, rate, md, *extra)
            for g, p, w in zip(got, plain, want):
                np.testing.assert_array_equal(g, p)
                np.testing.assert_array_equal(g, w)


def test_native_extract_field_matches_plain_and_jax():
    rng = np.random.default_rng(1)
    n, step = 257, 32
    blob = rng.integers(0, 256, n * step, dtype=np.uint8)
    vals = rng.normal(size=n) * 100
    view = blob.reshape(n, step)
    view[:, 0:4] = vals.astype(np.float32).view(np.uint8).reshape(n, 4)
    view[:, 8:16] = vals.view(np.uint8).reshape(n, 8)
    data = blob.tobytes()
    for offset, dtype in ((0, 7), (8, 8), (16, 6), (20, 5), (24, 4), (26, 2), (27, 1), (28, 3)):
        for f64 in (False, True):
            got = native.extract_field(data, n, step, offset, dtype, f64=f64)
            want = jnative.extract_field(data, n, step, offset, dtype, f64=f64)
            np.testing.assert_array_equal(got, native.extract_field_plain(data, n, step, offset,
                                                                          dtype, f64=f64))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == (np.float64 if f64 else np.float32)
    np.testing.assert_array_equal(native.extract_field(data, n, step, 8, 8, f64=True), vals)


def test_native_builds_into_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is built from the port's copy of the source into
    build/native/ (never beside the JAX package's source), under a name
    that carries the source's hash; a source that does not compile raises."""
    root = Path(native.__file__).resolve().parents[2]
    path = native.library_path()
    assert path.parent == root / "build" / "native" and path.name.startswith("libingest-")
    native.get_lib()
    assert path.is_file()
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.process_scan(np.zeros((4, 3), np.float32), np.zeros(4), 1, 0.0)
    assert not list((tmp_path / "native").glob("*.so"))


# ---------------------------------------------------------------------------
# fixture writers and readers
# ---------------------------------------------------------------------------

_BAG_KW = dict(real_time=False, LiDAR_type="velodyne", min_dist=0.5, downsample_rate=1,
               full_rotation_time=0.1, stamp_beginning=False, offset_beginning=True,
               points_topic="/velodyne_points", imus_topic="/vectornav/IMU")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One SimData written by both packages' writers: a bag each, and a
    KITTI drive each (rendered by each package's own simulator)."""
    d = tmp_path_factory.mktemp("fixtures")
    sim = sim_mod.simulate(sim_mod.room_world(size=20.0), sim_mod.circle_trajectory(3.0, 0.4),
                           Config(**_BAG_KW), duration=0.5, lidar_lines=6, pts_per_line=64,
                           imu_rate=100.0, seed=3)
    jfx.write_rosbag(str(d / "jax.bag"), sim, JConfig(**_BAG_KW))
    fx.write_rosbag(str(d / "torch.bag"), sim, Config(**_BAG_KW))
    kw = dict(duration=0.4, lidar_lines=6, pts_per_line=96, seed=5)
    ksim = fx.write_kitti_drive(str(d / "torch_drive"), sim_mod.corridor_world(length=60.0),
                                sim_mod.corridor_trajectory(speed=4.0),
                                KITTI.replace(imu_rate=100.0), **kw)
    jfx.write_kitti_drive(str(d / "jax_drive"), jsim.corridor_world(length=60.0),
                          jsim.corridor_trajectory(speed=4.0), J_KITTI.replace(imu_rate=100.0),
                          **kw)
    return d, sim, ksim


def test_writers_are_byte_identical_to_jax(written):
    d, _, _ = written
    assert (d / "jax.bag").read_bytes() == (d / "torch.bag").read_bytes()
    files = sorted(str(p.relative_to(d / "jax_drive")) for p in (d / "jax_drive").rglob("*")
                   if p.is_file())
    assert len(files) > 20
    assert files == sorted(str(p.relative_to(d / "torch_drive"))
                           for p in (d / "torch_drive").rglob("*") if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(d / "jax_drive", d / "torch_drive", files,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


def test_bag_reader_and_decoders_match_jax(written):
    d, sim, _ = written
    got = list(rosbag.BagReader(str(d / "torch.bag")).messages())
    want = list(jbag.BagReader(str(d / "torch.bag")).messages())
    assert [(m.topic, m.msg_type, m.t, m.raw) for m in got] == \
        [(m.topic, m.msg_type, m.t, m.raw) for m in want]
    assert sum(m.msg_type.endswith("Imu") for m in got) == len(sim.imu_t)
    for m in got:
        if m.msg_type.endswith("Imu"):
            for g, w in zip(rosbag.decode_imu(m.raw), jbag.decode_imu(m.raw)):
                np.testing.assert_array_equal(g, w)
        else:
            (sg, fg), (sw, fw) = rosbag.decode_pointcloud2(m.raw), jbag.decode_pointcloud2(m.raw)
            assert sg == sw and sorted(fg) == sorted(fw) == ["intensity", "time", "x", "y", "z"]
            for k in fg:
                np.testing.assert_array_equal(fg[k], fw[k])
    only = list(rosbag.BagReader(str(d / "torch.bag")).messages(topics=["/vectornav/IMU"]))
    assert len(only) == len(sim.imu_t)


def test_kitti_reader_and_oxts_trajectory_match_jax(written):
    d, _, ksim = written
    drive = str(d / "torch_drive")
    got, want = kitti.KittiRawReader(drive), jkitti.KittiRawReader(drive)
    scans_g, scans_w = list(got.scans()), list(want.scans())
    assert len(scans_g) == len(scans_w) == len(ksim.scans)
    for g, w in zip(scans_g, scans_w):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    imu_g, imu_w = list(got.imu()), list(want.imu())
    assert len(imu_g) == len(imu_w) == len(ksim.imu_t)
    for a, b in zip(imu_g, imu_w):
        assert a.t == b.t and (a.lat, a.lon, a.alt, a.roll, a.pitch, a.yaw) == \
            (b.lat, b.lon, b.alt, b.roll, b.pitch, b.yaw)
        np.testing.assert_array_equal(a.a, b.a)
        np.testing.assert_array_equal(a.w, b.w)
    for a, b in zip(kitti.oxts_trajectory(got), jkitti.oxts_trajectory(want)):
        np.testing.assert_array_equal(a, b)
    # the GT derivation inverts the writer's mercator: the fixture's ground
    # truth comes back to well under a millimetre
    t, _, p = kitti.oxts_trajectory(got)
    gi = np.searchsorted(ksim.gt_t, t)
    ok = (gi < len(ksim.gt_t)) & np.isclose(ksim.gt_t[np.minimum(gi, len(ksim.gt_t) - 1)], t,
                                             atol=1e-6)
    assert ok.sum() > 10
    np.testing.assert_allclose(p[ok], ksim.gt_p[gi[ok]] - ksim.gt_p[gi[ok]][0] + p[ok][0],
                               atol=1e-4)


class _FeedLog(_CallLog):
    def add_imu(self, t, a, w, q=None):
        self.calls.append(("imu", float(t)))


def test_kitti_feed_delivers_imu_past_the_scan_end_like_jax(written):
    """Reproduced, not fixed (ROADMAP, "Faults to reproduce, not fix"): the
    KITTI feed delivers the IMU samples up to `stamp + full_rotation_time`,
    where `stamp` is the scan's timestamps.txt entry, the middle of the
    rotation; the samples then run half a rotation past the scan's end, not
    up to its completion as the feed's comment says."""
    d, _, ksim = written
    cfg_t, cfg_j = KITTI.replace(imu_rate=100.0), J_KITTI.replace(imu_rate=100.0)
    got, want = _FeedLog(), _FeedLog()
    kitti.feed_pipeline(got, kitti.KittiRawReader(str(d / "torch_drive")), cfg_t)
    jkitti.feed_pipeline(want, jkitti.KittiRawReader(str(d / "torch_drive")), cfg_j)
    assert got.calls == want.calls
    last_imu, lead = None, []
    for c in got.calls:
        if c[0] == "imu":
            last_imu = c[1]
        elif c[0] == "scan":
            lead.append(last_imu - c[2])        # last IMU before the scan - its last point
    np.testing.assert_allclose(lead[:-1], 0.05, atol=0.011)   # rot/2 past the end, 100 Hz IMU


def test_pointcloud2_big_endian_flag_is_ignored_like_jax():
    """Reproduced, not fixed (ROADMAP): `decode_pointcloud2` reads every
    field little-endian whatever `is_bigendian` says, so a big-endian cloud
    decodes to byte-swapped values in both packages."""
    vals = np.array([1.5, -2.25, 8.0], np.float32)
    raw = struct.pack("<I", 0) + struct.pack("<II", 7, 0) + struct.pack("<I", 0)
    raw += struct.pack("<II", 1, 3) + struct.pack("<I", 1)
    raw += struct.pack("<I", 1) + b"x" + struct.pack("<IBI", 0, 7, 1)
    data = vals.astype(">f4").tobytes()
    raw += struct.pack("<B", 1) + struct.pack("<II", 4, 12) + struct.pack("<I", len(data)) + data
    raw += struct.pack("<B", 1)
    (_, got), (_, want) = rosbag.decode_pointcloud2(raw), jbag.decode_pointcloud2(raw)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["x"], vals.astype(">f4").view("<f4"))
    assert not np.array_equal(got["x"], vals)


def test_fixture_writer_writes_the_ros_time_of_each_stamp(written):
    """The bag's record times are the message stamps (sec, nsec), as the
    readers decode them."""
    d, sim, _ = written
    msgs = list(rosbag.BagReader(str(d / "torch.bag")).messages(topics=["/vectornav/IMU"]))
    np.testing.assert_allclose([m.t for m in msgs], sim.imu_t, atol=2e-9)
    assert os.path.getsize(d / "torch.bag") > 4096


def test_xaloc_profile_warmup_is_rejected_like_jax():
    """Reproduced, not fixed (ROADMAP): the XALOC profile's warm-up lists
    three times and three deltas, and the schedule wants one delta more
    than times, so its first real-time window fails in both packages.
    A consistent schedule (DEFAULT's) is accepted by both."""
    from limovelo_tpu.config import XALOC as J_XALOC
    from limovelo_tpu_torch.config import XALOC

    assert (XALOC.Initialization.times, XALOC.Initialization.deltas) == \
        (J_XALOC.Initialization.times, J_XALOC.Initialization.deltas)
    for init in (XALOC.Initialization, J_XALOC.Initialization):
        with pytest.raises(AssertionError, match="one more delta"):
            init.delta_at(0.0)
    assert DEFAULT.Initialization.delta_at(0.7) == J_DEFAULT.Initialization.delta_at(0.7) == 0.05
