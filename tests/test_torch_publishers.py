"""Port parity of the publishers: the packets and the text sinks of
`runtime/publishers.py`, and a pipeline run with every sink attached against
the JAX pipeline with the same sinks.

The JAX pipeline runs with one point bucket and one IMU bucket (one compile
of its step).  Both run the "rematch" match cadence: with "auto" the
neighbour sets frozen at the predicted pose carry a one-point difference of
the two packages' rounding on to later windows, and the two estimates drift
centimetres apart over two seconds of these scenes; re-searching each
iteration keeps them within a few millimetres.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu.runtime.publishers import PlanesPacket as JPlanesPacket
from limovelo_tpu.runtime.publishers import Publisher as JPublisher
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
from limovelo_tpu_torch.runtime.pipeline import LioPipeline, StepRecord
from limovelo_tpu_torch.runtime.publishers import PlanesPacket, Publisher
from limovelo_tpu_torch.runtime.slam import SlamPipeline

torch.set_num_threads(1)

POS_TOL = 0.005


def test_planes_packet_quaternions_rotate_x_onto_the_normal():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(128, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = (-1.0, 0.0, 0.0)                      # antipodal: a 180° turn
    q = PlanesPacket(t=0.0, centroids=np.zeros((128, 3)), normals=n).quaternions()
    np.testing.assert_array_equal(q, JPlanesPacket(t=0.0, centroids=np.zeros((128, 3)),
                                                   normals=n).quaternions())
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(Rsc.from_quat(q).apply(np.tile([1.0, 0, 0], (128, 1))), n,
                               atol=1e-6)


def _records(n=6):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        R = Rsc.from_rotvec(rng.normal(size=3) * 0.3).as_matrix().astype(np.float32)
        out.append(StepRecord(
            t=1316000000.0 + 0.1 * i + 1e-7 * i, R=R, p=rng.normal(size=3).astype(np.float32),
            v=rng.normal(size=3).astype(np.float32), updated=True, ds_count=900 + i,
            num_matches=700 - i, mean_residual=float(rng.uniform(0, 0.05)), iterations=3,
            wall_ms=float(rng.uniform(1, 90)), eigenvalues=rng.uniform(0, 500, 12),
            extr_rotvec=rng.normal(size=3) * 1e-3, extr_t=rng.normal(size=3),
            map_points=10000 + 37 * i, map_buckets=300 + i, map_dropped=i, delta_norm=1e-4 * i))
    return out


@pytest.mark.parametrize("verbose", [False, True])
def test_publisher_text_is_the_jax_text(tmp_path, verbose):
    """The same records (and loop events) through both Publishers give the
    same JSONL metrics and TUM trajectory, byte for byte."""
    pubs = {}
    for name, cls in (("jax", JPublisher), ("torch", Publisher)):
        pub = cls(str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}.tum"),
                  log_degeneracy=verbose, log_extrinsics=verbose)
        for i, rec in enumerate(_records()):
            pub.state(rec)
            if i == 3:
                pub.loop(rec.t, 7, 1, 0.0123456789, 812, True)
        pub.close()
        pubs[name] = pub
    for ext in ("jsonl", "tum"):
        assert (tmp_path / f"torch.{ext}").read_text() == (tmp_path / f"jax.{ext}").read_text()
    rows = [json.loads(ln) for ln in (tmp_path / "torch.jsonl").read_text().splitlines()]
    assert len(rows) == 7 and rows[4]["event"] == "loop"
    assert ("eigenvalues" in rows[0]) == verbose == ("extr_t" in rows[0])


class _Sinks:
    """Every sink of a Publisher, recording its packets."""

    def __init__(self, pub):
        self.log = {k: [] for k in ("state", "tf", "cloud", "full_cloud", "planes", "states",
                                    "extrinsics", "cloud2")}
        pub.on_state.append(self.log["state"].append)
        pub.on_tf.append(self.log["tf"].append)
        pub.on_cloud.append(lambda pts, t, intensity: self.log["cloud"].append((pts, t,
                                                                                intensity)))
        pub.on_cloud.append(lambda pts, t: self.log["cloud2"].append(len(pts)))   # 2-arg
        pub.on_full_cloud.append(lambda pts, t, intensity: self.log["full_cloud"].append(
            (pts, t, intensity)))
        pub.on_planes.append(self.log["planes"].append)
        pub.on_states.append(self.log["states"].append)
        pub.on_extrinsics.append(self.log["extrinsics"].append)


def _genuine(values, sim) -> float:
    """The share of `values` that are input intensities."""
    all_in = np.concatenate([s.intensity for s in sim.scans])
    return float(np.isin(np.round(values, 5), np.round(all_in, 5)).mean())


def test_pipeline_publishing_matches_jax(tmp_path):
    """A short run with every sink attached, through both pipelines: the
    same packets (counts, times), positions within 5 mm, planes one per
    match and unit length, the state history as long as the anchor
    history, and published intensities that are input intensities."""
    jc = J_DEFAULT.replace(map_table_size=1 << 12, point_buckets=(2048,), imu_buckets=(64,),
                           knn_rings=1, match_mode="rematch", print_extrinsics=True,
                           min_dist=0.5, downsample_prec=0.3, degeneracy_threshold=0.0)
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), tc,
                   duration=1.0, lidar_lines=8, pts_per_line=160, imu_rate=200.0, seed=3)
    runs = {}
    for name, pub_cls, pipe in (("jax", JPublisher, lambda p: JLioPipeline(jc, publisher=p)),
                                ("torch", Publisher,
                                 lambda p: LioPipeline(tc, device="cpu", publisher=p))):
        pub = pub_cls(str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}.tum"))
        sinks = _Sinks(pub)
        p = pipe(pub)
        replay_into(p, sim)
        runs[name] = (p.result, sinks.log, p)
        pub.close()
    (jr, jlog, _), (tr, tlog, tp) = runs["jax"], runs["torch"]
    assert len(tr.records) == len(jr.records) >= 6
    np.testing.assert_array_equal(tr.times, jr.times)
    assert np.linalg.norm(tr.positions - jr.positions, axis=1).max() < POS_TOL
    for k in tlog:
        assert len(tlog[k]) == len(jlog[k]) == len(tr.records), k
    np.testing.assert_allclose([p.p for p in tlog["state"]], tr.positions, rtol=0, atol=0)
    np.testing.assert_allclose([p.translation for p in tlog["tf"]],
                               [p.translation for p in jlog["tf"]], atol=POS_TOL)
    assert [p.t for p in tlog["extrinsics"]] == [p.t for p in jlog["extrinsics"]]
    for rec, planes in zip(tr.records, tlog["planes"]):
        assert len(planes.normals) == len(planes.centroids) == rec.num_matches
        np.testing.assert_allclose(np.linalg.norm(planes.normals, axis=-1), 1.0, atol=1e-4)
    for ts, js in zip(tlog["states"], jlog["states"]):
        assert len(ts.times) == len(js.times) == len(ts.positions) == len(ts.quaternions)
        np.testing.assert_array_equal(ts.times, js.times)
    assert len(tlog["states"][-1].times) == len(tp._anchors)
    for k in ("cloud", "full_cloud"):
        for (pts, t, inten), (jpts, jt, _) in zip(tlog[k], jlog[k]):
            assert t == jt and len(inten) == len(pts) and abs(len(pts) - len(jpts)) <= 8
        inten = np.concatenate([c[2] for c in tlog[k]])
        assert inten.max() > 0 and _genuine(inten, sim) > 0.99, k
    assert tlog["cloud2"] == [len(c[0]) for c in tlog["cloud"]]
    # full_cloud is the full-resolution window (high_quality_publish)
    assert len(tlog["full_cloud"][-1][0]) > len(tlog["cloud"][-1][0])
    text = (tmp_path / "torch.tum").read_text().splitlines()
    assert len(text) == len(tr.records)
    assert len((tmp_path / "torch.jsonl").read_text().splitlines()) == len(tr.records)


def test_offline_map_stream_and_loop_events(tmp_path, monkeypatch):
    """Offline mapping publishes the re-deskewed rotation as the map stream
    once per map update, with genuine intensities; and a SLAM pipeline puts
    each loop registration attempt into the metrics stream."""
    cfg = interop.config_from_kwargs(dict(
        mapping_online=False, map_table_size=1 << 12, point_buckets=(2048,), imu_buckets=(64,),
        knn_rings=1, min_dist=0.5, downsample_prec=0.3, high_quality_publish=False,
        imu_rate=200.0, real_time_delay=0.1))
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), cfg,
                   duration=0.9, lidar_lines=6, pts_per_line=128, imu_rate=200.0, seed=4)
    pub = Publisher()
    full = []
    pub.on_full_cloud.append(lambda pts, t, intensity: full.append((pts, intensity)))
    pipe = LioPipeline(cfg, device="cpu", publisher=pub)
    replay_into(pipe, sim)
    assert len(full) == pipe.timers.summary()["offline_map"]["n"] >= 2
    assert all(len(i) == len(p) > 0 for p, i in full)
    assert _genuine(np.concatenate([i for _, i in full]), sim) > 0.99

    import limovelo_tpu_torch.runtime.slam as slam

    pub = Publisher(str(tmp_path / "m.jsonl"))
    sp = SlamPipeline(cfg, device="cpu", publisher=pub)
    for k in range(3):
        sp.keyframes.add(0.1 * k, np.eye(3), np.array([0.1 * k, 0, 0]), np.zeros((4, 3)))
    monkeypatch.setattr(slam, "detect_loop_candidates", lambda ps, gap, dist: [(2, 0), (1, 0)])
    monkeypatch.setattr(slam, "register_scan_to_map",
                        lambda *a, **k: (np.eye(3), np.zeros(3), 0.05, 500))
    sp._check_loops()
    pub.close()
    rows = [json.loads(ln) for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(r["event"], r["i"], r["j"], r["accepted"]) for r in rows] == \
        [("loop", 2, 0, True), ("loop", 1, 0, True)]
    assert len(sp.loop_stats) == 2
