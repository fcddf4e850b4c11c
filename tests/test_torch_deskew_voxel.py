"""Port parity: deskew path integration, per-point compensation (padding and
superset invariance included) and the medoid voxel downsample, against the
JAX package on the CPU."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from limovelo_tpu import Config as JConfig
from limovelo_tpu.deskew.compensate import build_path as j_build_path
from limovelo_tpu.deskew.compensate import compensate as j_compensate
from limovelo_tpu.deskew.compensate import state_at as j_state_at
from limovelo_tpu.filter.process import ImuWindow as JImu
from limovelo_tpu.geometry import state as jst
from limovelo_tpu.ops.voxel import voxel_downsample as jvoxel
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.deskew import compensate as dk
from limovelo_tpu_torch.filter.process import ImuWindow
from limovelo_tpu_torch.ops.voxel import voxel_downsample

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, atol):
    np.testing.assert_allclose(interop.to_numpy(port), np.asarray(ref), rtol=0, atol=atol)


def _anchor(jc, rng):
    xj = jst.boxplus(jst.make_initial(jc), jnp.asarray(rng.normal(size=23) * 0.1, jnp.float32))
    return xj, interop.state_from_numpy({f: np.asarray(getattr(xj, f)) for f in xj._fields}, "cpu")


def _window(rng, M, n_valid, pre=0, t0=1.0, rate=100.0):
    """`n_valid` samples after t0 (the first `pre` of them moved before t0,
    as in a superset window), then padding up to M."""
    t = np.zeros(M, np.float32)
    a = np.zeros((M, 3), np.float32)
    w = np.zeros((M, 3), np.float32)
    mask = np.zeros(M, bool)
    ts = t0 + (np.arange(n_valid) + 1) / rate
    ts[:pre] -= 0.5
    t[:n_valid] = ts
    a[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.3 + [0.0, 0.0, 9.807]
    w[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.5
    mask[:n_valid] = True
    return t, a, w, mask


def test_build_path_and_compensate(rng):
    """Path nodes within 1e-5 (12 f32 integration steps), deskewed points
    within 2e-5 at 10 m ranges (a few ulps of the coordinates)."""
    jc = JConfig(I_Translation_L=(0.1, 0.0, -0.05),
                 I_Rotation_L=(0.866, -0.5, 0.0, 0.5, 0.866, 0.0, 0.0, 0.0, 1.0))
    xj, xt = _anchor(jc, rng)
    win = _window(rng, 16, 12)
    a0 = np.array([0.3, -0.1, 9.9], np.float32)
    w0 = np.array([0.05, 0.1, -0.2], np.float32)
    pj = jax.jit(j_build_path)(xj, jnp.float32(1.0), jnp.asarray(a0), jnp.asarray(w0),
                                 JImu(*(jnp.asarray(v) for v in win)))
    pt = dk.build_path(xt, T(np.float32(1.0)), T(a0), T(w0), ImuWindow(*(T(v) for v in win)))
    for f in pt._fields:
        close(getattr(pt, f), getattr(pj, f), atol=1e-5)

    n = 300
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    pts_t = rng.uniform(1.0, 1.12, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    t2 = np.float32(1.12)
    oj = jax.jit(j_compensate)(pj, xj, jnp.asarray(t2), jnp.asarray(pts), jnp.asarray(pts_t),
                                 jnp.asarray(mask))
    ot = dk.compensate(pt, xt, T(t2), T(pts), T(pts_t), T(mask))
    close(ot, oj, atol=2e-5)
    assert np.all(ot.numpy()[~mask] == 0.0)
    # state_at on the same path
    for tq in (1.0, 1.055, 1.2):
        for a, b in zip(dk.state_at(pt, xt, tq), j_state_at(pj, xj, jnp.float32(tq))):
            close(a, b, atol=1e-5)


def test_padding_and_superset_invariance():
    """The port's deskew does not move when the window gains trailing
    padding or leading pre-anchor rows (masked as the step masks them), and
    agrees with the JAX package on each variant (1e-5)."""
    jc = JConfig()
    xj = jst.make_initial(jc)
    xt = interop.state_from_numpy({f: np.asarray(getattr(xj, f)) for f in xj._fields}, "cpu")
    g = np.array(jc.gravity_vec, np.float32)
    pts = np.array([[5, 0, 0], [0, 5, 0], [3, 3, 1]], np.float32)
    pts_t = np.array([0.01, 0.05, 0.09], np.float32)
    msk = np.ones(3, bool)

    def win(M, pad, pre=0):
        ts = (np.arange(1, M + 1) * (0.1 / M)).astype(np.float32)
        if pre:
            ts = np.concatenate([ts[:pre] - 0.1, ts])
        t_ = np.zeros(pad, np.float32)
        aa = np.zeros((pad, 3), np.float32)
        ww = np.zeros((pad, 3), np.float32)
        mk = np.zeros(pad, bool)
        t_[:len(ts)] = ts
        aa[:len(ts)] = -g
        ww[:len(ts)] = [0, 0, 1.0]
        mk[:len(ts)] = ts > 0
        return t_, aa, ww, mk

    def run_port(w):
        path = dk.build_path(xt, T(np.float32(0.0)), T(-g), torch.zeros(3), ImuWindow(*(T(v) for v in w)))
        return dk.compensate(path, xt, T(np.float32(0.1)), T(pts), T(pts_t), T(msk)).numpy()

    def run_jax(w):
        path = j_build_path(xj, jnp.float32(0.0), jnp.asarray(-g), jnp.zeros(3),
                              JImu(*(jnp.asarray(v) for v in w)))
        return np.asarray(j_compensate(path, xj, jnp.float32(0.1), jnp.asarray(pts),
                                         jnp.asarray(pts_t), jnp.asarray(msk)))

    ref = run_port(win(8, 8))
    assert np.max(np.abs(ref - pts)) > 0.1, "deskew no-oped"
    for pad, pre in ((8, 0), (16, 0), (64, 0), (64, 4)):
        w = win(8, pad, pre)
        out = run_port(w)
        np.testing.assert_array_equal(out, ref)
        close(out, run_jax(w), atol=1e-5)


def _scan_like(rng, n):
    """A scan-like cloud: ground, two walls and clutter, at 0.5-30 m."""
    kind = rng.integers(0, 4, n)
    r = rng.uniform(0.5, 30, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(-1.5, 2, n)], -1)
    pts[kind == 0, 2] = -1.6 + rng.normal(0, 0.01, (kind == 0).sum())
    pts[kind == 1, 0] = 8.0 + rng.normal(0, 0.01, (kind == 1).sum())
    pts[kind == 2, 1] = -6.0 + rng.normal(0, 0.01, (kind == 2).sum())
    return pts.astype(np.float32)


def test_voxel_downsample_identical(rng):
    """Same count, mask and input index for every row.  Exact: on the CPU
    both sides sum each voxel's points in sorted order, and the medoid's
    squared distance is rounded as the JAX package's compiled code rounds it
    (see `ops.voxel.sq_norm3`), so even near-ties pick the same point."""
    n = 4096
    pts = _scan_like(rng, n)
    mask = np.zeros(n, bool)
    mask[:3500] = True
    for leaf in (0.2, 0.5):
        dj = jax.jit(jvoxel)(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(leaf))
        dt = voxel_downsample(T(pts), T(mask), float(np.float32(leaf)))
        assert int(dt.count) == int(dj.count) > 500
        np.testing.assert_array_equal(dt.mask.numpy(), np.asarray(dj.mask))
        np.testing.assert_array_equal(dt.idx.numpy(), np.asarray(dj.idx))
        np.testing.assert_array_equal(dt.pts.numpy(), np.asarray(dj.pts))
