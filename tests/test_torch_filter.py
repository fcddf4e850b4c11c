"""Port parity: IMU prediction, chart transport, H rows and the iterated
update (all three match modes) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the map is
built by the JAX package's `insert` and carried into the port with
`interop`, so both updates search the very same table.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limovelo_tpu import Config as JConfig
from limovelo_tpu.filter import process as jproc
from limovelo_tpu.filter import update as jupd
from limovelo_tpu.geometry import state as jst
from limovelo_tpu.mapping import hashgrid as jhg
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.filter import process as proc
from limovelo_tpu_torch.filter import update as upd
from limovelo_tpu_torch.geometry import state as st
from limovelo_tpu_torch.mapping.hashgrid import GridParams

torch.set_num_threads(1)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(interop.to_numpy(port), np.asarray(ref), rtol=rtol, atol=atol)


def _state_fields(x):
    return {f: np.asarray(getattr(x, f)) for f in st.NavState._fields}


def _pair_state(xj):
    """A JAX NavState and the same values as a port NavState."""
    return interop.state_from_numpy(_state_fields(xj), "cpu")


def _imu_window(rng, M, n_valid, t0=0.0, rate=200.0):
    t = np.zeros(M, np.float32)
    a = np.zeros((M, 3), np.float32)
    w = np.zeros((M, 3), np.float32)
    mask = np.zeros(M, bool)
    t[:n_valid] = t0 + (np.arange(n_valid) + 1) / rate
    a[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.3 + [0.0, 0.0, 9.807]
    w[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.4
    mask[:n_valid] = True
    return t, a, w, mask


def test_predict_window_padded(rng):
    """64-entry window, 40 valid then padding: padded entries are identity
    updates.  Tolerance: x 1e-5 (40 f32 integration steps, the port sums p
    and v as running sums), P to 1e-6 of its largest entry (40 chained
    23×23 f32 products, summed in another order).  The JAX side runs
    eagerly: compiling its 64-step unrolled replay took most of this file's
    time."""
    cfg = JConfig(covariance_gyroscope=6e-4, covariance_acceleration=1.5e-2)
    tc = interop.config_from_kwargs(dict(covariance_gyroscope=6e-4,
                                         covariance_acceleration=1.5e-2))
    xj = jst.boxplus(jst.make_initial(cfg), jnp.asarray(rng.normal(size=23) * 0.1, jnp.float32))
    P = np.asarray(jst.initial_covariance(cfg))
    win = _imu_window(rng, 64, 40)
    xpj, Ppj = jproc.predict_window(
        xj, jnp.asarray(P), jproc.ImuWindow(*(jnp.asarray(v) for v in win)),
        jnp.float32(0.0), jproc.process_noise_Q(cfg))
    xpt, Ppt = proc.predict_window(
        _pair_state(xj), T(P), proc.ImuWindow(*(T(v) for v in win)), 0.0,
        proc.process_noise_Q(tc, device="cpu"))
    for f in st.NavState._fields:
        close(getattr(xpt, f), getattr(xpj, f), atol=1e-5)
    close(Ppt, Ppj, atol=1e-6 * np.abs(np.asarray(Ppj)).max())
    # one sample's nominal step, on its own
    a, w, dt = win[1][0], win[2][0], np.float32(0.005)
    xn_t = proc.nominal_step(_pair_state(xj), T(a), T(w), T(dt))
    xn_j = jproc.nominal_step(xj, jnp.asarray(a), jnp.asarray(w), jnp.asarray(dt))
    for f in st.NavState._fields:
        close(getattr(xn_t, f), getattr(xn_j, f), atol=1e-6)
    # the padding really is identity: the 40-entry window gives the same
    # result bit for bit on the port
    short = tuple(v[:40] for v in win)
    xs, Ps = proc.predict_window(_pair_state(xj), T(P), proc.ImuWindow(*(T(v) for v in short)),
                                 0.0, proc.process_noise_Q(tc, device="cpu"))
    close(xs.p, xpt.p, atol=0)
    close(Ps, Ppt, atol=0)


def test_chart_transport_and_observation_matrix(rng):
    """L: the port's written-out blocks against the JAX package's
    forward-mode AD through ⊞/⊟, 1e-5.  H rows: closed forms, 1e-5 at lever
    arms of 10 m."""
    cfg = JConfig(I_Translation_L=(0.3, 0.0, -0.1))
    x0 = jst.boxplus(jst.make_initial(cfg), jnp.asarray(rng.normal(size=23) * 0.3, jnp.float32))
    x = jst.boxplus(x0, jnp.asarray(rng.normal(size=23) * 0.05, jnp.float32))
    Lj = jupd.chart_transport(x, x0)
    Lt = upd.chart_transport(_pair_state(x), _pair_state(x0))
    close(Lt, Lj, atol=1e-5)
    close(upd.chart_transport(_pair_state(x0), _pair_state(x0)), np.eye(23), atol=1e-6)

    pts = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    for ext in (False, True):
        Hj = jupd.observation_matrix(x, jnp.asarray(pts), jnp.asarray(n), ext)
        Ht = upd.observation_matrix(_pair_state(x), T(pts), T(n), ext)
        close(Ht, Hj, atol=1e-5)


# ---------------------------------------------------------------------------
# the iterated update on a map both sides share
# ---------------------------------------------------------------------------

_UPDATE_KW = dict(knn_rings=1, map_table_size=1 << 12, MAX_NUM_ITERS=3,
                  degeneracy_threshold=5.0, huber_delta=0.02)


def _room_points(rng, n, noise=0.003):
    """Points on a 12 × 10 × 3 m room's floor and walls, plus one box."""
    face = rng.integers(0, 6, n)
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    x = np.where(face == 0, -6.0, np.where(face == 1, 6.0, -6 + 12 * u))
    y = np.where(face == 2, -5.0, np.where(face == 3, 5.0, -5 + 10 * np.where(face < 2, u, v)))
    z = np.where(face == 4, 0.0, 3.0 * v)
    box = face == 5      # the top of a 2 × 2 × 1 m box
    x = np.where(box, 1 + 2 * u, x)
    y = np.where(box, -2 + 2 * v, y)
    z = np.where(box, 1.0, z)
    pts = np.stack([x, y, z], -1) + rng.normal(0, noise, (n, 3))
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def update_scene():
    rng = np.random.default_rng(7)
    jc = JConfig(**_UPDATE_KW)
    jgrid = jhg.GridParams.from_config(jc)
    world = _room_points(rng, 12000)
    m = jhg.insert(jhg.make_map(jgrid), jnp.asarray(world), jnp.ones(len(world), bool), jgrid)
    # true pose: 1.5 m into the room, lidar 1.2 m up; the predicted state x0
    # is off by 6 cm and 0.8°
    x_true = jst.make_initial(jc)._replace(
        p=jnp.asarray([1.5, -0.5, 1.2], jnp.float32),
        R=jnp.asarray(np.eye(3), jnp.float32))
    dx = np.zeros(23, np.float32)
    dx[0:3] = [0.04, -0.03, 0.03]
    dx[3:6] = [0.005, -0.008, 0.01]
    x0 = jst.boxplus(x_true, jnp.asarray(dx))
    # the window: 384 fresh surface samples in the LiDAR frame, 128 padding
    scan_w = _room_points(rng, 384)
    pts = np.zeros((512, 3), np.float32)
    pts[:384] = scan_w - np.array([1.5, -0.5, 1.2], np.float32)
    mask = np.zeros(512, bool)
    mask[:384] = True
    P = np.asarray(jst.initial_covariance(jc)) * 1e-2
    return dict(jc=jc, jgrid=jgrid, m=m, x0=x0, pts=pts, mask=mask, P=P)


@pytest.mark.parametrize("mode", ["rematch", "freeze", "auto"])
def test_iterated_update(update_scene, mode):
    """x⁺ within 1e-5 (the f64 solve leaves only f32 rounding of HᵀH and
    the residuals), P⁺ within 1e-7 absolute, and identical match counts and
    iterations: both sides search the same table with the same dense KNN."""
    s = update_scene
    jc = s["jc"].replace(match_mode=mode)
    tc = interop.config_from_kwargs(dict(_UPDATE_KW, match_mode=mode))
    xj, Pj, dj = jupd.iterated_update(
        s["x0"], jnp.asarray(s["P"]), s["m"], jnp.asarray(s["pts"]), jnp.asarray(s["mask"]),
        s["jgrid"], jc.static(), jc.dynamic())
    m_t = interop.map_from_numpy({k: np.asarray(v) for k, v in s["m"]._asdict().items()}, "cpu")
    xt, Pt, dt = upd.iterated_update(
        _pair_state(s["x0"]), T(s["P"]), m_t, T(s["pts"]), T(s["mask"]),
        GridParams.from_config(tc), tc.static(), tc.dynamic())

    assert int(dt.num_matches) == int(dj.num_matches) > 200
    assert int(dt.iterations) == int(dj.iterations)
    np.testing.assert_array_equal(dt.plane_valid.numpy(), np.asarray(dj.plane_valid))
    for f in st.NavState._fields:
        close(getattr(xt, f), getattr(xj, f), atol=1e-5)
    close(Pt, Pj, atol=1e-7)
    close(dt.mean_residual, dj.mean_residual, atol=1e-6)
    close(dt.eigenvalues, dj.eigenvalues, atol=0, rtol=1e-4)
    # the update really corrected the 6 cm / 0.8° prediction error
    assert np.linalg.norm(xt.p.numpy() - np.array([1.5, -0.5, 1.2])) < 0.01
