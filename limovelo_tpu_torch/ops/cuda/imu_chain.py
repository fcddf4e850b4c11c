"""The IMU chains of the device step as hand-written CUDA kernels
(`csrc/imu_chain.cu`), bound with ctypes:

- `predict`: the filter's propagation through a padded IMU window
  (`filter/process.py::predict_window_plain`), one CTA;
- `path`: the deskew path's nodes (`deskew/compensate.py::build_path_plain`,
  with lio_step's strictly-after-anchor mask and anchor controls when
  `after_anchor`), one CTA;
- `deskew`: every point to the LiDAR frame at t2
  (`deskew/compensate.py::compensate_plain`), a thread per point.

Each takes CUDA tensors only and launches once on PyTorch's current stream,
reading nothing back; the dispatchers `predict_window`, `build_path` and
`compensate` send CPU tensors to the plain versions instead.  Each launch
counts `imu_chain.launches` and `imu_chain.<kernel>.launches` (`predict`,
`path`, `deskew`) in the current recorder (runtime/profiling.py).
"""

from __future__ import annotations

import ctypes

import torch

from ...runtime import profiling
from .build import check_tensor, load

ERROR_DIM = 23
NOISE_DIM = 12
#: `predict`'s output buffer: P (23×23) at 0, R at 532, p at 544, v at 548
_OUT_R, _OUT_P, _OUT_V, _OUT_FLOATS = 532, 544, 548, 552
#: floats per path node: t, R (9), p, v, a, w (3 each)
_NODE_FLOATS = 22

_F32 = torch.float32


def _pointers(*names):
    return [(n, ctypes.c_void_p) for n in names]


def _ints(*names):
    return [(n, ctypes.c_int) for n in names]


class _PredictArgs(ctypes.Structure):
    _fields_ = _pointers("R", "p", "v", "bg", "ba", "g", "P", "Q", "t", "acc", "gyr", "mask",
                         "t0", "out") + _ints("m", "mv")


class _PathArgs(ctypes.Structure):
    _fields_ = _pointers("R", "p", "v", "bg", "ba", "g", "t0", "a0", "w0", "t", "acc", "gyr",
                         "mask", "nodes", "node_mask") + _ints("m", "mv", "after_anchor")


class _DeskewArgs(ctypes.Structure):
    _fields_ = _pointers("nt", "nR", "np", "nv", "na", "nw", "bg", "ba", "g", "R_LI", "t_LI",
                         "t2", "pts", "pts_t", "pts_mask", "out") + _ints("s", "n", "mv")


def _mv_kind(n: int) -> int:
    """How cuBLAS rounds a batched matrix-vector product of n 3×3 matrices
    (`DotKind` in csrc/imu_chain.cu): its kernel, and with it the order of
    the three products, changes with the batch size.  Measured on an H100
    with PyTorch 2.11 and CUDA 12.8; `tests/test_torch_cuda.py` holds the
    kernels to the plain functions bit for bit at every IMU bucket of the
    configurations (8 to 512), every point bucket from 512 to 131072 (from
    65536 on, the first 65535 points) and the shards of 128 and 256 points
    that two or four ranks take of the smallest."""
    return 2 if 16384 <= n <= 32768 else 1


_entry_points = {}


def _launch(kernel: str, args: ctypes.Structure, dev: torch.device) -> None:
    """Launch `imu_<kernel>_kernel` through its entry point and count it."""
    fn = _entry_points.get(kernel)
    if fn is None:
        fn = getattr(load("imu_chain"), f"imu_{kernel}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(type(args)), ctypes.c_void_p]
        _entry_points[kernel] = fn
    err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"imu_{kernel}_launch: CUDA launch failed: cudaError {err}")
    profiling.count("imu_chain.launches")
    profiling.count(f"imu_chain.{kernel}.launches")


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"imu_chain takes CUDA tensors, got one on {t.device}")
    return t.device


def _scalar(v: torch.Tensor, name: str, dev) -> torch.Tensor:
    """A one-element view of a 0-dim or one-element f32 tensor on `dev`."""
    check_tensor(v, name, _F32, v.shape, dev)
    if v.numel() != 1:
        raise ValueError(f"{name}: expected one element, got shape {tuple(v.shape)}")
    return v.reshape(1)


def _check_state(x, dev, fields=("R", "p", "v", "bg", "ba", "g")) -> None:
    for f in fields:
        check_tensor(getattr(x, f), f"state.{f}", _F32, (3, 3) if f in ("R", "R_LI") else (3,),
                     dev)


def _check_window(imus, dev) -> int:
    M = imus.t.shape[0]
    check_tensor(imus.t, "imus.t", _F32, (M,), dev)
    check_tensor(imus.a, "imus.a", _F32, (M, 3), dev)
    check_tensor(imus.w, "imus.w", _F32, (M, 3), dev)
    check_tensor(imus.mask, "imus.mask", torch.bool, (M,), dev)
    return M


def predict(x, P: torch.Tensor, imus, t0, Q: torch.Tensor):
    """(R, p, v, P) after the window: `predict_window_plain`'s propagation
    in one launch (the kernel's note in `csrc/imu_chain.cu`)."""
    dev = _device_of(P)
    _check_state(x, dev)
    check_tensor(P, "P", _F32, (ERROR_DIM, ERROR_DIM), dev)
    check_tensor(Q, "Q", _F32, (NOISE_DIM, NOISE_DIM), dev)
    M = _check_window(imus, dev)
    t0 = _scalar(t0, "t0", dev)
    out = torch.empty(_OUT_FLOATS, dtype=_F32, device=dev)
    ptrs = [t.data_ptr() for t in (x.R, x.p, x.v, x.bg, x.ba, x.g, P, Q, imus.t, imus.a,
                                   imus.w, imus.mask, t0, out)]
    _launch("predict", _PredictArgs(*ptrs, M, _mv_kind(M)), dev)
    return (out[_OUT_R:_OUT_R + 9].view(3, 3), out[_OUT_P:_OUT_P + 3],
            out[_OUT_V:_OUT_V + 3], out[:ERROR_DIM * ERROR_DIM].view(ERROR_DIM, ERROR_DIM))


def path(anchor, anchor_t, anchor_a, anchor_w, imus, after_anchor: bool):
    """The path nodes' fields (t, R, p, v, a, w, mask) for `PathNodes`:
    `build_path`'s nodes in one launch, with the anchor's controls derived
    on the card when `after_anchor`."""
    dev = _device_of(anchor.p)
    _check_state(anchor, dev)
    M = _check_window(imus, dev)
    S = M + 1
    t0 = _scalar(anchor_t, "anchor_t", dev)
    check_tensor(anchor_a, "anchor_a", _F32, (3,), dev)
    check_tensor(anchor_w, "anchor_w", _F32, (3,), dev)
    nodes = torch.empty(_NODE_FLOATS * S, dtype=_F32, device=dev)
    node_mask = torch.empty(S, dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (anchor.R, anchor.p, anchor.v, anchor.bg, anchor.ba,
                                   anchor.g, t0, anchor_a, anchor_w, imus.t, imus.a, imus.w,
                                   imus.mask,
                                   nodes, node_mask)]
    _launch("path", _PathArgs(*ptrs, M, _mv_kind(M), int(after_anchor)), dev)
    R = nodes[S:10 * S].view(S, 3, 3)
    p, v, a, w = (nodes[k * S:(k + 3) * S].view(S, 3) for k in (10, 13, 16, 19))
    return nodes[:S], R, p, v, a, w, node_mask


def deskew(path_nodes, anchor, t2, pts: torch.Tensor, pts_t: torch.Tensor,
           pts_mask: torch.Tensor) -> torch.Tensor:
    """`compensate_plain`'s (N, 3) points in the LiDAR frame at t2 in one
    launch; masked rows are zeros."""
    dev = _device_of(pts)
    _check_state(anchor, dev, ("bg", "ba", "g", "R_LI", "t_LI"))
    S = path_nodes.t.shape[0]
    check_tensor(path_nodes.t, "path.t", _F32, (S,), dev)
    check_tensor(path_nodes.R, "path.R", _F32, (S, 3, 3), dev)
    for f in ("p", "v", "a", "w"):
        check_tensor(getattr(path_nodes, f), f"path.{f}", _F32, (S, 3), dev)
    N = pts.shape[0]
    check_tensor(pts, "pts", _F32, (N, 3), dev)
    check_tensor(pts_t, "pts_t", _F32, (N,), dev)
    check_tensor(pts_mask, "pts_mask", torch.bool, (N,), dev)
    out = torch.empty((N, 3), dtype=_F32, device=dev)
    if N == 0:
        return out
    t2 = _scalar(t2, "t2", dev)
    ptrs = [t.data_ptr() for t in (*path_nodes[:6], anchor.bg, anchor.ba, anchor.g,
                                   anchor.R_LI, anchor.t_LI, t2, pts, pts_t, pts_mask, out)]
    _launch("deskew", _DeskewArgs(*ptrs, S, N, _mv_kind(N)), dev)
    return out
