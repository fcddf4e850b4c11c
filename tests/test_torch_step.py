"""Port parity: one `lio_step`, and two chained steps with the map threaded,
on the inputs of `__graft_entry__._make_example`, with the grouped KNN on
both sides (the JAX package's Pallas kernel in interpret mode, the port's
plain version on the CPU).

One point bucket (512) and one IMU bucket (16) keep the JAX side to a
single short compile; the table is small because interpret mode walks it
per group.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import limovelo_tpu.ops.pallas.knn as pallas_knn
from limovelo_tpu import Config as JConfig
from limovelo_tpu.step import lio_step as j_lio_step
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.config import DynParams
from limovelo_tpu_torch.filter.process import ImuWindow, process_noise_Q
from limovelo_tpu_torch.mapping.hashgrid import GridParams
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.step import (TEL_MAP_BUCKETS, TEL_MAP_DROPPED, TEL_MAP_POINTS,
                                      StepInputs, lio_step)

from __graft_entry__ import _make_example

torch.set_num_threads(1)

CFG_KW = dict(real_time=False, min_dist=0.5, downsample_prec=0.3, map_table_size=1 << 11,
              knn_rings=1, knn_backend="pallas")


@pytest.fixture
def interpreted_pallas(monkeypatch):
    """`update._search` imports `knn_grouped` at call time, so patching the
    module attribute reaches the step without touching the JAX package."""
    monkeypatch.setattr(pallas_knn, "knn_grouped",
                        functools.partial(pallas_knn.knn_grouped, interpret=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_inputs(inp_np, tc):
    """The JAX StepInputs (as numpy) as the port's StepInputs on the CPU."""
    T = lambda a: torch.as_tensor(np.array(a))
    st = lambda x: interop.state_from_numpy(x._asdict(), "cpu")
    return StepInputs(
        anchor=st(inp_np.anchor), anchor_t=T(inp_np.anchor_t), anchor_a=T(inp_np.anchor_a),
        anchor_w=T(inp_np.anchor_w), x=st(inp_np.x), P=T(inp_np.P),
        t_integrated=T(inp_np.t_integrated),
        imus_filter=ImuWindow(*(T(v) for v in inp_np.imus_filter)),
        imus_path=ImuWindow(*(T(v) for v in inp_np.imus_path)),
        pts=T(inp_np.pts), pts_t=T(inp_np.pts_t), pts_mask=T(inp_np.pts_mask), t2=T(inp_np.t2),
        Q=process_noise_Q(tc, device="cpu"), dyn=DynParams.from_config(tc))


def _next_inputs(inp, out, dt=0.1):
    """The example window repeated `dt` later, from the step's outputs."""
    shift = lambda w: w._replace(t=w.t + dt)
    return inp._replace(
        anchor=out.anchor, anchor_t=out.anchor_t, x=out.x, P=out.P,
        t_integrated=inp.t2, imus_filter=shift(inp.imus_filter), imus_path=shift(inp.imus_path),
        pts_t=inp.pts_t + dt, t2=inp.t2 + dt)


def _compare(out_t, out_j, flips_before):
    """Field-by-field comparison of StepOutputs; returns the medoid flips
    so far.  Exact for the counts, flags and masks; 1e-5 for the state
    (f32, the solve runs in f64 on both sides); 5e-5 for world-frame points
    at 10 m (a few ulps, plus the state's ~1e-6 rotation difference over the
    10 m lever arm).  P to 1e-4 of its largest entry: the predicted P
    reaches a condition number near 6e5, and the update's two inversions
    amplify the f32 rounding of the 23×23 chains (relative 5e-7, summed in
    another order) by up to that.  A voxel whose two nearest points tie to
    within the f32 rounding of the deskewed coordinates may take another
    medoid (at most 2 rows a step); the map then holds another point in at
    most that many fine cells, so its counters may differ by as many."""
    assert bool(out_t.updated) == bool(out_j.updated)
    assert int(out_t.ds_count) == int(out_j.ds_count)
    d_t, d_j = out_t.diag, out_j.diag
    assert int(d_t.num_matches) == int(d_j.num_matches)
    assert int(d_t.iterations) == int(d_j.iterations)
    np.testing.assert_array_equal(d_t.plane_valid.numpy(), d_j.plane_valid)
    np.testing.assert_allclose(float(d_t.mean_residual), float(d_j.mean_residual), atol=1e-6)
    for f in out_t.x._fields:
        np.testing.assert_allclose(getattr(out_t.x, f).numpy(), getattr(out_j.x, f), atol=1e-5)
        np.testing.assert_allclose(getattr(out_t.anchor, f).numpy(), getattr(out_j.anchor, f),
                                   atol=1e-5)
    np.testing.assert_allclose(out_t.P.numpy(), out_j.P, rtol=0, atol=1e-4 * np.abs(out_j.P).max())
    assert float(out_t.anchor_t) == float(out_j.anchor_t)
    np.testing.assert_array_equal(out_t.global_ds_mask.numpy(), out_j.global_ds_mask)
    same = out_t.global_ds_idx.numpy() == out_j.global_ds_idx
    flips = flips_before + int((~same).sum())
    assert flips - flips_before <= 2
    np.testing.assert_allclose(out_t.global_ds.numpy()[same], out_j.global_ds[same], atol=5e-5)
    np.testing.assert_allclose(out_t.global_pts.numpy(), out_j.global_pts, atol=5e-5)
    tel_t, tel_j = out_t.telemetry.numpy(), out_j.telemetry
    counters = [TEL_MAP_POINTS, TEL_MAP_BUCKETS, TEL_MAP_DROPPED]
    rest = np.setdiff1d(np.arange(len(tel_j)), counters)
    np.testing.assert_allclose(tel_t[rest], tel_j[rest], rtol=1e-5, atol=2e-5)
    for f, i in zip(("num_points", "num_buckets", "dropped"), counters):
        assert abs(int(getattr(out_t.map, f)) - int(getattr(out_j.map, f))) <= flips, f
        assert int(getattr(out_t.map, f)) == int(tel_t[i])
    return flips


def test_one_and_two_chained_steps(interpreted_pallas):
    jc = JConfig(**CFG_KW)
    tc = interop.config_from_kwargs({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    inp_j, m_j, jc, grid_j = _make_example(jc, n_pts=512, n_imu=16)
    grid_t = GridParams.from_config(tc)
    inp_t = _port_inputs(_np(inp_j), tc)
    m_t = interop.map_from_numpy(_np(m_j)._asdict(), "cpu")

    flips = 0
    for step in range(2):
        out_j = _np(j_lio_step(inp_j, m_j, jc.static(), grid_j))   # donates m_j
        launches = profiling.current().counters["knn_grouped.launches"]
        out_t = lio_step(inp_t, m_t, tc.static(), grid_t)
        # the CPU runs the plain version
        assert profiling.current().counters["knn_grouped.launches"] == launches
        flips = _compare(out_t, out_j, flips)
        if step == 0:
            assert int(out_t.map.num_points) > 400
        m_j = jax.tree.map(jnp.asarray, out_j.map)
        m_t = out_t.map
        inp_j = _next_inputs(inp_j, jax.tree.map(jnp.asarray, out_j))
        inp_t = _next_inputs(inp_t, out_t)
