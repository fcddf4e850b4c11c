"""Port parity: geometry (SO(3), S², the 23-dim filter-state chart).

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port on the CPU.  Tolerance 1e-6 absolute (f32): both sides
evaluate the same closed forms; what remains is f32 rounding of a few
operations in another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limovelo_tpu import Config as JConfig
from limovelo_tpu.geometry import s2 as js2
from limovelo_tpu.geometry import so3 as jso3
from limovelo_tpu.geometry import state as jst
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.geometry import s2, so3
from limovelo_tpu_torch.geometry import state as st

torch.set_num_threads(1)

ATOL = 1e-6


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(port), np.asarray(ref), rtol=0, atol=atol)


def _rotvecs(rng):
    """Generic, near-zero (Taylor branch) and near-π (argmax quaternion
    branch) rotation vectors."""
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0.1, 3.0, 4),
        [0.0, 1e-7, 5e-5, 2e-4],
        [np.pi - 1e-3, np.pi - 1e-5, np.pi, np.pi - 0.05],
    ])
    return (axes * angles[:, None]).astype(np.float32)


def test_so3_exp_log_hat(rng):
    w = _rotvecs(rng)
    close(so3.hat(T(w)), jso3.hat(jnp.asarray(w)))
    R_ref = np.asarray(jso3.exp(jnp.asarray(w)))
    close(so3.exp(T(w)), R_ref)
    close(so3.vee(so3.hat(T(w))), w)
    # log on the same matrices: 0 and π both go through the quaternion
    # branch picked by the largest pivot.  Near π the angle's conditioning
    # is 1/sin(θ/2)-free but the axis sign is a convention: compare the
    # rotation it encodes.
    lw_t = so3.log(T(R_ref))
    lw_j = np.asarray(jso3.log(jnp.asarray(R_ref)))
    close(lw_t, lw_j, atol=1e-5)
    close(so3.exp(lw_t), R_ref, atol=1e-5)
    close(so3._to_quat(T(R_ref)), jso3._to_quat(jnp.asarray(R_ref)))


def test_so3_boxplus_boxminus(rng):
    w1, w2 = _rotvecs(rng), _rotvecs(np.random.default_rng(1))
    R1 = np.asarray(jso3.exp(jnp.asarray(w1)))
    dw = (rng.normal(size=w1.shape) * 0.1).astype(np.float32)
    close(so3.boxplus(T(R1), T(dw)), jso3.boxplus(jnp.asarray(R1), jnp.asarray(dw)))
    R2 = np.asarray(jso3.exp(jnp.asarray(w2[:4])))
    close(so3.boxminus(T(R1[:4]), T(R2)), jso3.boxminus(jnp.asarray(R1[:4]), jnp.asarray(R2)),
          atol=1e-5)


def test_s2(rng):
    g = rng.normal(size=(16, 3)).astype(np.float32)
    g[:3] = [[0, 0, -9.807], [9.807, 0, 0], [0, 1e-3, 9.8]]   # axis-aligned branches
    g = (g / np.linalg.norm(g, axis=1, keepdims=True) * 9.807).astype(np.float32)
    d = (rng.normal(size=(16, 2)) * 0.05).astype(np.float32)
    close(s2.basis(T(g)), js2.basis(jnp.asarray(g)))
    gp = s2.boxplus(T(g), T(d))
    close(gp, js2.boxplus(jnp.asarray(g), jnp.asarray(d)), atol=1e-5)
    gp_np = interop.to_numpy(gp)
    # ⊟ recovers δ; 1e-5 since ‖g‖ = 9.8 scales the f32 rounding of g⊞δ
    close(s2.boxminus(T(gp_np), T(g)), js2.boxminus(jnp.asarray(gp_np), jnp.asarray(g)),
          atol=1e-5)
    close(s2.dexp_dg(T(g)), js2.dexp_dg(jnp.asarray(g)), atol=1e-5)


@pytest.fixture
def cfg_pair():
    kw = dict(I_Translation_L=(0.1, -0.2, 0.05),
              I_Rotation_L=(0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0),
              initial_cov_extrinsic_rot=(1e-4, 1e-4, 1e-8))
    return JConfig(**kw), interop.config_from_kwargs(kw)


def test_make_initial_and_covariance(cfg_pair):
    jc, tc = cfg_pair
    R0 = np.asarray(jso3.exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    xj = jst.make_initial(jc, R0=R0)
    xt = st.make_initial(tc, R0=R0, device="cpu")
    for f in st.NavState._fields:
        close(getattr(xt, f), getattr(xj, f))
    close(st.initial_covariance(tc, device="cpu"), jst.initial_covariance(jc), atol=0)
    close(st.initial_covariance(device="cpu"), jst.initial_covariance(), atol=0)


def test_state_boxplus_boxminus(rng, cfg_pair):
    jc, tc = cfg_pair
    xj = jst.make_initial(jc)
    xt = st.make_initial(tc, device="cpu")
    dx = (rng.normal(size=23) * 0.2).astype(np.float32)
    yj = jst.boxplus(xj, jnp.asarray(dx))
    yt = st.boxplus(xt, T(dx))
    for f in st.NavState._fields:
        close(getattr(yt, f), getattr(yj, f), atol=1e-5)
    # x ⊞ dx ⊟ x recovers dx on both sides
    close(st.boxminus(yt, xt), jst.boxminus(yj, xj), atol=1e-5)
    close(st.boxminus(yt, xt), dx, atol=1e-5)


def test_chart_blocks_match_jax_autodiff(rng):
    """The port writes the chart-transport blocks out; the JAX package gets
    them by forward-mode AD.  SO(3): J_r⁻¹(w) = J_l⁻¹(−w), 1e-5 (the
    (θ/2)·cot(θ/2) term loses a few ulps near π).  S²: ∂((g ⊞ δ) ⊟ g0)/∂δ
    against jax.jacfwd, with g = g0 (the s → 0 branch) and apart, 1e-5."""
    import jax

    w = _rotvecs(rng)
    close(so3.right_jacobian_inv(T(w)), jso3.left_jacobian_inv(-jnp.asarray(w)), atol=1e-5)
    g0 = rng.normal(size=(6, 3))
    g0 = (g0 / np.linalg.norm(g0, axis=1, keepdims=True) * 9.807).astype(np.float32)
    d = np.concatenate([np.zeros((2, 2)), rng.normal(size=(4, 2)) * 0.05]).astype(np.float32)
    g = np.asarray(js2.boxplus(jnp.asarray(g0), jnp.asarray(d)))
    for gi, g0i in zip(g, g0):
        want = jax.jacfwd(lambda dd: js2.boxminus(js2.boxplus(jnp.asarray(gi), dd),
                                                   jnp.asarray(g0i)))(jnp.zeros(2, jnp.float32))
        close(s2.transport(T(gi), T(g0i)), want, atol=1e-5)


def test_so3_left_jacobians_and_normalize(rng):
    """`left_jacobian`, `left_jacobian_inv` and `normalize` against the JAX
    package's, at random angles and within the Taylor branch (θ < 1e-4);
    J_l·J_l⁻¹ = I and a normalized perturbed rotation is orthonormal."""
    w = np.concatenate([rng.normal(size=(64, 3)), rng.normal(size=(8, 3)) * 1e-6,
                        np.zeros((1, 3))]).astype(np.float32)
    close(so3.left_jacobian(T(w)), jso3.left_jacobian(jnp.asarray(w)), atol=1e-5)
    close(so3.left_jacobian_inv(T(w)), jso3.left_jacobian_inv(jnp.asarray(w)), atol=1e-5)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (len(w), 3, 3))
    close(so3.left_jacobian(T(w)) @ so3.left_jacobian_inv(T(w)), eye, atol=1e-4)
    R = np.asarray(jso3.exp(jnp.asarray(w))) + rng.normal(0, 1e-3, (len(w), 3, 3)).astype(np.float32)
    Rn = so3.normalize(T(R))
    close(Rn, jso3.normalize(jnp.asarray(R)), atol=1e-6)
    close(Rn.transpose(-1, -2) @ Rn, eye, atol=1e-5)
