"""Port parity: checkpoints and HD maps cross between the two packages.

- A checkpoint the JAX package saved mid-run, loaded by the port, continues
  like the JAX run that saved it; a checkpoint the port saved loads into the
  JAX package's `load_checkpoint` and continues the same way; both files
  hold the same keys with the same dtypes and shapes.  Online and offline
  mapping.
- An HD map saved by the JAX `save_map` drives a frozen-map replay in both
  packages: the map is bit-identical after the run.

The scene is tests/test_torch_pipeline.py's (a 12 m room, a 2.5 m circle)
seen by a 16 × 128 LiDAR, with the dense KNN and a 0.3 m voxel leaf (more
matches per window than DEFAULT's 0.5 m, so the two packages stay within
~3 mm over the resumed stretch); both pipelines resolve at depth 1.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.io.simulate import replay_into as j_replay_into
from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu.runtime.checkpoint import load_checkpoint as j_load_checkpoint
from limovelo_tpu.runtime.checkpoint import save_checkpoint as j_save_checkpoint
from limovelo_tpu.runtime.pipeline import LioPipeline as JLioPipeline
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.io.simulate import (SimScan, circle_trajectory, replay_into,
                                            room_world, simulate)
from limovelo_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from limovelo_tpu_torch.runtime.pipeline import LioPipeline

from torch_scenes import save_jax_hd_map, world_cloud

torch.set_num_threads(1)

#: positions agree to 5 mm (see tests/test_torch_pipeline.py)
POS_TOL = 0.005
CUT = 8          # scans fed before the checkpoint


def _configs(mapping):
    jc = J_DEFAULT.replace(knn_backend="xla", knn_rings=1, map_table_size=1 << 12,
                           downsample_prec=0.3, point_buckets=(2048,), imu_buckets=(64,),
                           mapping=mapping)
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    return jc, tc


def _scene(tc, duration=1.1):
    world, traj = room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5)
    sim = simulate(world, traj, tc, duration=duration, lidar_lines=16, pts_per_line=128,
                   imu_rate=200.0)
    return world, traj, sim


def _after(result, t_cut):
    keep = result.times > t_cut
    return result.times[keep], result.positions[keep]


class _Calls:
    """A pipeline stand-in that records what is fed to it."""

    def __init__(self):
        self.calls = []

    def add_imu(self, t, a, w):
        self.calls.append(("imu", t))

    def add_scan(self, pts, t, intensity=None):
        self.calls.append(("scan", len(pts)))

    def spin(self):
        self.calls.append(("spin",))


def test_split_replay_feeds_one_replay():
    """`replay_into` over scans [0, k) and then [k, n) makes the calls of one
    replay, which are the JAX package's `replay_into`'s, an empty scan
    included (a run stopped at a scan boundary to checkpoint goes on as if
    it never stopped)."""
    _, tc = _configs("online")
    _, _, sim = _scene(tc, duration=0.6)
    s = sim.scans[2]
    sim.scans[2] = SimScan(pts=s.pts[:0], t=s.t[:0], stamp=s.stamp, intensity=s.intensity[:0])
    whole, ref = _Calls(), _Calls()
    replay_into(whole, sim)
    j_replay_into(ref, sim)
    assert whole.calls == ref.calls
    for k in range(len(sim.scans)):
        split = _Calls()
        replay_into(split, sim, 0, k)
        replay_into(split, sim, k)
        assert split.calls == whole.calls, k


@pytest.mark.parametrize("mapping", ["online", "offline"])
def test_checkpoints_cross_both_ways(tmp_path, mapping):
    jc, tc = _configs(mapping)
    _, _, sim = _scene(tc)
    t_cut = sim.scans[CUT - 1].t[-1]

    # the JAX run, checkpointed at the cut
    jp = JLioPipeline(jc, defer_readback=False)
    replay_into(jp, sim, 0, CUT)
    ck_j = str(tmp_path / "jax.npz")
    j_save_checkpoint(ck_j, jp)
    replay_into(jp, sim, CUT)
    t_ref, p_ref = _after(jp.result, t_cut)
    assert len(t_ref) >= 4

    # JAX checkpoint → port
    tp = LioPipeline(tc, device="cpu")
    load_checkpoint(ck_j, tp)
    assert [a.t for a in tp._anchors] == [a.t for a in tp._anchors_d] != []
    replay_into(tp, sim, CUT)
    t_got, p_got = _after(tp.result, t_cut)
    np.testing.assert_array_equal(t_got, t_ref)
    assert np.linalg.norm(p_got - p_ref, axis=1).max() < POS_TOL

    # port checkpoint → JAX
    tp2 = LioPipeline(tc, device="cpu")
    replay_into(tp2, sim, 0, CUT)
    ck_t = str(tmp_path / "port.npz")
    save_checkpoint(ck_t, tp2)
    with np.load(ck_j) as a, np.load(ck_t) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    jp2 = JLioPipeline(jc, defer_readback=False)
    j_load_checkpoint(ck_t, jp2)
    replay_into(jp2, sim, CUT)
    t_got, p_got = _after(jp2.result, t_cut)
    np.testing.assert_array_equal(t_got, t_ref)
    assert np.linalg.norm(p_got - p_ref, axis=1).max() < POS_TOL


def test_frozen_hd_map_from_jax(tmp_path):
    """An HD map of the room (rays cast from nine ground-truth poses) saved
    by the JAX `save_map`; both packages localize against it with the map
    frozen: the port's map is bit-identical before and after the run and to
    the JAX package's, positions agree within 5 mm."""
    jc, tc = _configs(None)
    world, traj, sim = _scene(tc, duration=0.9)
    hd = tmp_path / "room.npz"
    save_jax_hd_map(hd, world_cloud(world, traj, np.linspace(0, 0.9, 9)), jc.map_table_size)

    jp = JLioPipeline.from_hd_map(jc, str(hd), grid=jhg.GridParams.from_config(jc))
    jp.defer_readback = False
    assert jp.config.mapping_mode == "none"
    replay_into(jp, sim)
    tp = LioPipeline.from_hd_map(tc, str(hd), device="cpu")
    assert tp.config.mapping_mode == "none"
    before = {k: v.clone() for k, v in tp._preloaded_map._asdict().items()}
    replay_into(tp, sim)

    jr, tr = jp.result, tp.result
    assert len(tr.records) >= 6
    np.testing.assert_array_equal(tr.times, jr.times)
    assert np.linalg.norm(tr.positions - jr.positions, axis=1).max() < POS_TOL
    jmap = jax.tree.map(np.asarray, jp.map)._asdict()
    for k, v in tp.map._asdict().items():
        assert torch.equal(v, before[k]), k
        np.testing.assert_array_equal(v.numpy(), jmap[k], k)
    assert int(tp.map.num_points) > 1000
