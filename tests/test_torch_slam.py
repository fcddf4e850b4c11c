"""Port parity: the SLAM backend — keyframes, pose-graph Gauss-Newton, loop
detection and scan registration, and `SlamPipeline` end to end — against
the JAX package on the CPU."""

import dataclasses

import numpy as np
import torch
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as Rsc

from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.geometry import so3 as jso3
from limovelo_tpu.graph import KeyframeSelector as JKeyframeSelector
from limovelo_tpu.graph import PoseGraph as JPoseGraph
from limovelo_tpu.graph import detect_loop_candidates as j_detect
from limovelo_tpu.graph import optimize_pose_graph as j_optimize
from limovelo_tpu.graph import register_scan_to_map as j_register
from limovelo_tpu.runtime.slam import SlamPipeline as JSlamPipeline
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.geometry import so3
from limovelo_tpu_torch.graph import (KeyframeSelector, PoseGraph, detect_loop_candidates,
                                      optimize_pose_graph, register_scan_to_map)
from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
from limovelo_tpu_torch.runtime.slam import SlamPipeline

torch.set_num_threads(1)


def _circle_poses(K, radius=10.0):
    th = np.linspace(0, 2 * np.pi, K)
    ps = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros(K)], 1)
    Rs = np.stack([Rsc.from_euler("z", t + np.pi / 2).as_matrix() for t in th])
    return Rs.astype(np.float32), ps.astype(np.float32)


def test_right_jacobian_inv_is_jax_left_of_negated(rng):
    """The pose graph's J_r⁻¹(r): the port's `right_jacobian_inv(r)` is the
    JAX package's `left_jacobian_inv(−r)`, to 1e-6, at angles from 0 (the
    Taylor branch) to 3 rad."""
    w = np.concatenate([rng.normal(size=(200, 3)),
                        rng.normal(size=(50, 3)) * 1e-6]).astype(np.float32)
    w *= np.float32(np.minimum(1.0, 3.0 / np.linalg.norm(w, axis=1, keepdims=True)))
    got = so3.right_jacobian_inv(torch.as_tensor(w)).numpy()
    want = np.asarray(jso3.left_jacobian_inv(jnp.asarray(-w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_keyframe_selector_decides_like_jax(rng):
    sel_t, sel_j = KeyframeSelector(1.0, 10.0), JKeyframeSelector(1.0, 10.0)
    for _ in range(200):
        R = Rsc.from_rotvec(rng.normal(size=3) * 0.2).as_matrix()
        p = rng.normal(size=3) * 1.5
        assert sel_t.should_add(R, p) == sel_j.should_add(R, p)


def test_pose_graph_matches_jax():
    """A drifted 30-pose loop with one exact loop edge at weight 100:
    positions within 1e-4 m and rotations within 1e-4 of the JAX solve (both
    f32; the scatter-adds and the dense solve round in another order), costs
    within 1e-4 relative."""
    Rs, ps = _circle_poses(30)
    drift = np.linspace(0, 1.0, 30)[:, None] * np.array([0.5, 0.3, 0.1])
    yaw = Rsc.from_rotvec(np.outer(np.linspace(0, 0.2, 30), [0.0, 0.0, 1.0])).as_matrix()
    Rs_bad = (Rs @ yaw).astype(np.float32)
    ps_bad = (ps + drift).astype(np.float32)
    graphs = []
    for G in (PoseGraph, JPoseGraph):
        g = G()
        g.add_odometry_chain(Rs_bad, ps_bad)
        g.add_edge(0, 29, Rs[0].T @ Rs[-1], Rs[0].T @ (ps[-1] - ps[0]), weight=100.0)
        graphs.append(g)
    Rt, pt, ct = optimize_pose_graph(graphs[0], Rs_bad, ps_bad, iters=10, device="cpu")
    Rj, pj, cj = j_optimize(graphs[1], Rs_bad, ps_bad, iters=10)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-6)
    assert cj[-1] < 1e-3 * cj[0]
    assert detect_loop_candidates(ps, 20, 3.0) == j_detect(ps, 20, 3.0) != []


def test_register_scan_to_map_matches_jax(rng):
    """Point-to-plane registration of a scan seen from a known offset (the
    scene of tests/test_graph.py, 2000-point scan so the default_rng(0)
    subsample runs): R and p within 1e-4 of the JAX result, the same match
    count, rms within 1e-5."""
    target = np.concatenate([
        np.stack([rng.uniform(-8, 8, 2000), rng.uniform(-8, 8, 2000), np.full(2000, -1.2)], 1),
        np.stack([rng.uniform(-8, 8, 1000), np.full(1000, 5.0), rng.uniform(-1, 3, 1000)], 1),
        np.stack([np.full(1000, 6.0), rng.uniform(-8, 8, 1000), rng.uniform(-1, 3, 1000)], 1),
    ]).astype(np.float32)
    R_true = Rsc.from_euler("z", 4, degrees=True).as_matrix().astype(np.float32)
    p_true = np.array([0.3, -0.2, 0.1], np.float32)
    scan = ((target[rng.choice(len(target), 2000, replace=False)] - p_true) @ R_true)
    scan = scan.astype(np.float32)
    R0, p0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Rt, pt, rms_t, n_t = register_scan_to_map(scan, target, R0, p0, max_points=1500, device="cpu")
    Rj, pj, rms_j, n_j = j_register(scan, target, R0, p0, max_points=1500)
    assert n_t == n_j > 500
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4)
    assert abs(rms_t - rms_j) < 1e-5
    np.testing.assert_allclose(pt, p_true, atol=0.03)


def test_slam_pipeline_replay_matches_jax():
    """A 2 s run on a 4 m circle through both `SlamPipeline`s (dense KNN,
    keyframes every 0.5 m, loop checks every second keyframe against frames
    at least three back, within 5 m): the same keyframe times, the same loop
    attempts with the same verdicts, optimized positions within 5 mm.  The
    0.3 m voxel leaf gives each window more matches than DEFAULT's 0.5 m:
    the two packages' odometry then stays within ~2.5 mm here, where on
    weakly constrained windows (faster turns, fewer matches) it drifts
    centimetres apart, as tests/test_torch_pipeline.py notes."""
    jc = J_DEFAULT.replace(knn_backend="xla", knn_rings=1, map_table_size=1 << 12,
                           downsample_prec=0.3, point_buckets=(2048,), imu_buckets=(32,))
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=4.0, omega=0.5), tc,
                   duration=2.0, lidar_lines=16, pts_per_line=128, imu_rate=200.0)
    kw = dict(kf_min_translation=0.5, loop_check_every=2, loop_min_index_gap=2)
    jp = JSlamPipeline(jc, **kw)
    replay_into(jp, sim)
    jp.flush()
    tp = SlamPipeline(tc, device="cpu", **kw)
    replay_into(tp, sim)

    kt = [f.t for f in tp.keyframes.frames]
    assert kt == [f.t for f in jp.keyframes.frames] and len(kt) >= 4
    pairs = lambda p: [(s["i"], s["j"], bool(s["accepted"])) for s in p.loop_stats]
    assert pairs(tp) == pairs(jp) != []
    _, ps_t = tp.optimized_trajectory()
    _, ps_j = jp.optimized_trajectory()
    assert tp.consensus_rejected == jp.consensus_rejected
    assert np.linalg.norm(ps_t - ps_j, axis=1).max() < 0.005
