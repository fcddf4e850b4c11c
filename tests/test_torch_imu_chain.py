"""The IMU chains' dispatch on the CPU (`filter/process.py::predict_window`,
`deskew/compensate.py::build_path` and `compensate`): CPU tensors take the
plain functions, bit for bit and without a launch, and the plain functions
agree with the JAX package on the CPU; the kernels' wrapper refuses what it
cannot launch.  The kernels themselves are held to the plain functions on
the card (`tests/test_torch_cuda.py`)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imu_cases as ic
from limovelo_tpu.deskew.compensate import build_path as j_build_path
from limovelo_tpu.deskew.compensate import compensate as j_compensate
from limovelo_tpu.filter import process as jproc
from limovelo_tpu.geometry import state as jst
from limovelo_tpu.step import _derive_anchor_controls as j_anchor_controls
from limovelo_tpu_torch.deskew import compensate as dk
from limovelo_tpu_torch.filter import process as proc
from limovelo_tpu_torch.ops.cuda import build, imu_chain
from limovelo_tpu_torch.runtime import profiling
from limovelo_tpu_torch.runtime.profiling import StageTimers

torch.set_num_threads(1)

T0 = 12.5     # rebased seconds into a run


def _flat(v):
    return [v] if isinstance(v, torch.Tensor) else [t for f in v for t in _flat(f)]


def _equal(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert torch.equal(g, w), (what, k, float((g.double() - w.double()).abs().max()))


def _close(got, want, atol, what):
    """Field by field within `atol` of the JAX package's NamedTuple (or array)."""
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    for k, (g, w) in enumerate(pairs):
        np.testing.assert_allclose(g.double().numpy(), np.asarray(w, np.float64), rtol=0,
                                   atol=atol, err_msg=f"{what} {k}")


def _j(v):
    """A torch tensor, a NavState or an ImuWindow as the JAX package's."""
    if isinstance(v, torch.Tensor):
        return jnp.asarray(v.numpy())
    return {"NavState": jst.NavState, "ImuWindow": jproc.ImuWindow}[type(v).__name__](
        **{f: _j(getattr(v, f)) for f in v._fields})


@pytest.fixture
def recorder():
    before = profiling.current()
    rec = StageTimers()
    profiling.install(rec)
    yield rec
    profiling.install(before)


@pytest.mark.parametrize("M,layout", [(8, "tail"), (16, "interleaved"), (64, "superset"),
                                      (128, "tail"), (16, "masked"), (32, "before")])
def test_cpu_dispatch_is_the_unchanged_plain_path(recorder, M, layout):
    """On CPU tensors `predict_window`, `build_path` (lio_step's
    strictly-after-anchor path and mapping_step's as-given one) and
    `compensate` are the plain functions, bit for bit, and launch nothing;
    lio_step's path still makes its two anchor-control reads and `state_at`
    its six.  The plain functions agree with the JAX package, whose lio_step
    masks its path and derives the anchor's controls as `after_anchor`
    does: R, p, v within 1e-5 and P within 1e-6 of its largest entry (as
    `test_torch_filter.py` holds the prediction), path nodes within 1e-5
    (as `test_torch_deskew_voxel.py`), points out to 80 m within 2e-4 m
    (the nodes' rotations differ by about 1.4e-6 after 128 samples, which
    80 m turns into 1e-4 m)."""
    rng = np.random.default_rng(M)
    x, P, Q = ic.state(rng), ic.covariance(rng), ic.noise()
    win = ic.window(rng, M, layout, T0)
    t0 = torch.tensor(T0, dtype=torch.float32)
    a0, w0 = ic.controls(rng)
    pred = proc.predict_window(x, P, win, t0, Q)
    lio = dk.build_path(x, t0, a0, w0, win, after_anchor=True)
    mapping = dk.build_path(x, t0, a0, w0, win)
    t2 = lio.t[-1] + 0.0003
    pts, pts_t, msk = ic.points(rng, 2048, T0, float(t2), node_t=lio.t.numpy())
    out = dk.compensate(lio, x, t2, pts, pts_t, msk)
    c = recorder.counters
    assert c["imu_chain.launches"] == 0
    assert c["sync.anchor_controls"] == 2 and c["sync.state_at"] == 6

    _equal(pred, proc.predict_window_plain(x, P, win, t0, Q), "predict")
    _equal(lio, dk.build_path_plain(x, t0, a0, w0, win, after_anchor=True), "lio path")
    _equal(mapping, dk.build_path_plain(x, t0, a0, w0, win), "mapping path")
    _equal(out, dk.compensate_plain(lio, x, t2, pts, pts_t, msk), "compensate")

    # the JAX package on the CPU: its prediction eagerly (faster than
    # compiling the unrolled replay), the path and the points compiled
    xj, jwin, jt0 = _j(x), _j(win), jnp.float32(T0)
    xpj, Ppj = jproc.predict_window(xj, _j(P), jwin, jt0, _j(Q))
    _close([pred[0].R, pred[0].p, pred[0].v], [xpj.R, xpj.p, xpj.v], 1e-5, "predict x")
    _close(pred[1], Ppj, 1e-6 * float(np.abs(np.asarray(Ppj)).max()), "predict P")
    jmask = jwin._replace(mask=jwin.mask & (jwin.t > jt0))
    ja, jw = j_anchor_controls(SimpleNamespace(imus_path=jmask, anchor_a=_j(a0),
                                               anchor_w=_j(w0)), jmask.mask)
    lio_j = jax.jit(j_build_path)(xj, jt0, ja, jw, jmask)
    _close([f.float() for f in lio], lio_j, 1e-5, "lio path")
    _close([f.float() for f in mapping],
           jax.jit(j_build_path)(xj, jt0, _j(a0), _j(w0), jwin), 1e-5, "mapping path")
    _close(out, jax.jit(j_compensate)(lio_j, xj, _j(t2), _j(pts), _j(pts_t), _j(msk)), 2e-4,
           "compensate")


def test_cpu_pipeline_windows_launch_no_kernel():
    """A CPU pipeline's windows run the plain chains: no `imu_chain` launch,
    and each window makes lio_step's eight 0-dim index reads."""
    from limovelo_tpu_torch.config import DEFAULT
    from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    cfg = DEFAULT.replace(knn_rings=1, knn_backend="grouped", map_table_size=1 << 12,
                          min_dist=0.5, downsample_prec=0.3, imu_rate=200.0,
                          real_time_delay=0.1)
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5),
                   cfg, duration=0.6, lidar_lines=8, pts_per_line=64, imu_rate=200.0)
    pipe = LioPipeline(cfg, device="cpu")
    replay_into(pipe, sim)
    c, windows = pipe.timers.counters, pipe.timers.window
    assert windows >= 3
    assert c["imu_chain.launches"] == 0
    assert c["sync.anchor_controls"] == 2 * windows and c["sync.state_at"] == 6 * windows


def _cpu_inputs(M=16):
    rng = np.random.default_rng(1)
    x = ic.state(rng)
    win = ic.window(rng, M, "tail", T0)
    return x, ic.covariance(rng), win, ic.noise()


@pytest.mark.parametrize("call", ["predict", "path", "deskew"])
def test_kernel_wrapper_refuses_cpu_tensors(call):
    """The kernels take CUDA tensors only: handed CPU tensors, the wrapper
    raises before it loads or launches anything."""
    x, P, win, Q = _cpu_inputs()
    t0 = torch.tensor(T0)
    path = dk.build_path(x, t0, *ic.controls(np.random.default_rng(2)), win)
    pts = torch.zeros((4, 3))
    calls = {
        "predict": lambda: imu_chain.predict(x, P, win, t0, Q),
        "path": lambda: imu_chain.path(x, t0, path.a[0], path.w[0], win, True),
        "deskew": lambda: imu_chain.deskew(path, x, t0, pts, torch.zeros(4),
                                           torch.ones(4, dtype=torch.bool)),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[call]()


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "strided"])
def test_check_tensor_refuses_what_a_kernel_cannot_read(bad):
    """`ops/cuda/build.check_tensor`, the wrappers' check: a kernel reads raw
    contiguous memory of one dtype and shape on one device."""
    good = torch.zeros((4, 3), dtype=torch.float32)
    build.check_tensor(good, "x", torch.float32, (4, 3), torch.device("cpu"))
    t, dev = {"dtype": (good.double(), "cpu"), "shape": (good[:3], "cpu"),
              "device": (good, "meta"), "strided": (torch.zeros((3, 4)).T, "cpu")}[bad]
    with pytest.raises(ValueError):
        build.check_tensor(t, "x", torch.float32, (4, 3), torch.device(dev))
