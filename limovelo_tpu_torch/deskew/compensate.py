"""Motion deskew (port of `limovelo_tpu/deskew/compensate.py`).

- `build_path` integrates the anchor state (latest corrected state at/before
  t1) through the IMU samples covering (t_anchor, t2] into a fixed-shape
  array of path nodes.
- `compensate` brackets every point's timestamp among the nodes, integrates
  the residual dt in closed form and maps the point into the LiDAR frame at
  t2.

On CUDA tensors each is one launch of a kernel in `csrc/imu_chain.cu`
(`ops/cuda/imu_chain.py`) that reads nothing back to the host; on CPU
tensors they run `build_path_plain` and `compensate_plain`.

Frames:  p_lidar --(T_IL = I_Rt_L)--> p_imu --(X_tp)--> world
         then world --(X_t2 · T_IL)⁻¹--> lidar@t2.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..filter.process import ImuWindow, masked_dt, rotation_chain
from ..geometry import so3
from ..geometry.state import NavState
from ..ops.cuda import imu_chain
from ..runtime import profiling


class PathNodes(NamedTuple):
    """Upsampled state path over the window; node i is the state at t[i].

    Segment i (between t[i] and t[i+1]) uses controls (a[i], w[i]) — the
    smoothed IMU controls active after node i.  A masked-out node carries
    its predecessor's time and state."""

    t: torch.Tensor      # (S,)
    R: torch.Tensor      # (S, 3, 3)
    p: torch.Tensor      # (S, 3)
    v: torch.Tensor      # (S, 3)
    a: torch.Tensor      # (S, 3)  control for segment starting at node i
    w: torch.Tensor      # (S, 3)
    mask: torch.Tensor   # (S,) bool


def _integrate(R, p, v, bg, ba, g, a, w, dt):
    """One constant-control integration step (batched over leading dims)."""
    acc_w = (R @ (a - ba)[..., None])[..., 0] + g
    d = dt[..., None]
    R_n = R @ so3.exp((w - bg) * d)
    p_n = p + v * d + 0.5 * acc_w * (dt * dt)[..., None]
    v_n = v + acc_w * d
    return R_n, p_n, v_n


def build_path(anchor: NavState, anchor_t, anchor_a, anchor_w, imus: ImuWindow,
               after_anchor: bool = False) -> PathNodes:
    """Integrate `anchor` through the IMU window → path nodes: the CUDA
    kernel for CUDA tensors, `build_path_plain` otherwise.

    `after_anchor` (`step.lio_step`'s path): only samples strictly after
    `anchor_t` count, since the host may hand over a superset window
    selected from a lower bound of the anchor time, and the controls at the
    anchor are the first such sample's (`anchor_a`/`anchor_w` when there is
    none).  Without it (`step.mapping_step`) the mask and the controls are
    taken as given."""
    if anchor.p.device.type == "cuda":
        return PathNodes(*imu_chain.path(anchor, anchor_t, anchor_a, anchor_w, imus,
                                         after_anchor))
    return build_path_plain(anchor, anchor_t, anchor_a, anchor_w, imus, after_anchor)


def _first_controls(imus: ImuWindow, anchor_a, anchor_w):
    """Controls at the anchor = the window's first valid sample; the
    host-provided controls when the window holds none."""
    any_valid = torch.any(imus.mask)
    first = torch.argmax(imus.mask.to(torch.int32))   # first True
    # an index by a 0-dim tensor reads it to the host, once per indexing
    with profiling.blocking("sync.anchor_controls", 2):
        a_first, w_first = imus.a[first], imus.w[first]
    return (torch.where(any_valid, a_first, anchor_a),
            torch.where(any_valid, w_first, anchor_w))


def build_path_plain(anchor: NavState, anchor_t, anchor_a, anchor_w, imus: ImuWindow,
                     after_anchor: bool = False) -> PathNodes:
    """`build_path` in plain PyTorch, on whatever device the tensors are
    (the kernel's reference).

    Node 0 is the anchor with its last controls (anchor_a/anchor_w); node
    i+1 is the state after IMU entry i, integrated with that entry's
    incoming controls.  The carried controls are smoothed (½ old + ½ new)
    over the valid entries."""
    if after_anchor:
        imus = imus._replace(mask=imus.mask & (imus.t > anchor_t))
        anchor_a, anchor_w = _first_controls(imus, anchor_a, anchor_w)
    dtype, dev = anchor.p.dtype, anchor.p.device
    t0 = torch.as_tensor(anchor_t, dtype=dtype, device=dev).reshape(1)
    M = imus.t.shape[0]
    valid = imus.mask
    dt = masked_dt(imus.t, valid, t0)
    d = dt[:, None]

    Rs = rotation_chain(anchor.R, so3.exp((imus.w - anchor.bg) * d))       # (M+1,3,3)
    acc_w = (Rs[:-1] @ (imus.a - anchor.ba)[..., None])[..., 0] + anchor.g
    vs = torch.cumsum(torch.cat([anchor.v[None], acc_w * d]), dim=0)        # (M+1,3)
    dp = vs[:-1] * d + 0.5 * acc_w * (dt * dt)[:, None]
    ps = torch.cumsum(torch.cat([anchor.p[None], dp]), dim=0)              # (M+1,3)

    # carried node times: a masked entry repeats its predecessor's time
    idx = torch.where(valid, torch.arange(1, M + 1, device=dev), 0)
    t_nodes = torch.cat([t0, imus.t])[torch.cummax(torch.cat([idx.new_zeros(1), idx]), 0).values]

    # control smoothing over valid entries: ½ s + ½ a, computed as ½ (s + a)
    # (halving is exact, so both round identically)
    aw = torch.cat([imus.a, imus.w], dim=-1)                               # (M,6)
    s = torch.cat([torch.as_tensor(anchor_a, dtype=dtype, device=dev),
                   torch.as_tensor(anchor_w, dtype=dtype, device=dev)])
    smoothed = [s]
    for i in range(M):
        s = torch.where(valid[i], 0.5 * (s + aw[i]), s)
        smoothed.append(s)
    ctl = torch.stack(smoothed)                                            # (M+1,6)

    return PathNodes(
        t=t_nodes,
        R=Rs,
        p=ps,
        v=vs,
        a=ctl[:, :3],
        w=ctl[:, 3:],
        mask=torch.cat([torch.ones(1, dtype=torch.bool, device=dev), valid]),
    )


def _bracket(carried_t: torch.Tensor, query_t: torch.Tensor) -> torch.Tensor:
    """Index of the last node with effective time ≤ query (per element).

    `carried_t` is `path.t` raw: an invalid node holds its predecessor's
    time, so counting `carried_t <= q` lands exactly on the last node whose
    effective time ≤ q, for any interleaving of invalid entries.  Never mask
    invalid nodes to −inf here: a −inf row still counts as ≤ q and would
    shift every index past its true bracket on padded windows."""
    le = carried_t <= query_t[..., None]                  # (..., S)
    return torch.clamp(torch.sum(le, dim=-1) - 1, 0, carried_t.shape[0] - 1)


def state_at(path: PathNodes, anchor: NavState, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pose (R, p, v) at scalar time t: bracketing node + residual integration."""
    t = torch.as_tensor(t, dtype=path.t.dtype, device=path.t.device)
    s = _bracket(path.t, t)
    # an index by the 0-dim `s` reads it to the host, once per indexing
    with profiling.blocking("sync.state_at", 6):
        t_s, R_s, p_s, v_s, a_s, w_s = (path.t[s], path.R[s], path.p[s], path.v[s],
                                        path.a[s], path.w[s])
    dt = torch.clamp(t - t_s, min=0.0)
    return _integrate(R_s, p_s, v_s, anchor.bg, anchor.ba, anchor.g, a_s, w_s, dt)


def compensate(path: PathNodes, anchor: NavState, t2, pts: torch.Tensor,
               pts_t: torch.Tensor, pts_mask: torch.Tensor) -> torch.Tensor:
    """Deskew (N,3) LiDAR-frame points stamped `pts_t` to the LiDAR frame at
    t2; masked rows come back as zeros.  The CUDA kernel for CUDA tensors,
    `compensate_plain` otherwise."""
    if pts.device.type == "cuda":
        return imu_chain.deskew(path, anchor, t2, pts, pts_t, pts_mask)
    return compensate_plain(path, anchor, t2, pts, pts_t, pts_mask)


def compensate_plain(path: PathNodes, anchor: NavState, t2, pts: torch.Tensor,
                     pts_t: torch.Tensor, pts_mask: torch.Tensor) -> torch.Tensor:
    """`compensate` in plain PyTorch, on whatever device the tensors are
    (the kernel's reference)."""
    seg = _bracket(path.t, pts_t)
    dt = torch.clamp(pts_t - path.t[seg], min=0.0)
    d = dt[:, None]

    R_s = path.R[seg]          # (N,3,3)
    acc_w = torch.einsum("nij,nj->ni", R_s, path.a[seg] - anchor.ba) + anchor.g
    R_tp = R_s @ so3.exp((path.w[seg] - anchor.bg) * d)
    p_tp = path.p[seg] + path.v[seg] * d + 0.5 * acc_w * (dt * dt)[:, None]

    # lidar → imu → world at tp
    p_imu = pts @ anchor.R_LI.T + anchor.t_LI
    p_world = torch.einsum("nij,nj->ni", R_tp, p_imu) + p_tp

    # world → lidar frame at t2
    R_t2, p_t2, _ = state_at(path, anchor, t2)
    R_w2l = anchor.R_LI.T @ R_t2.T
    t_w2l = -R_w2l @ p_t2 - anchor.R_LI.T @ anchor.t_LI
    out = p_world @ R_w2l.T + t_w2l
    return torch.where(pts_mask[:, None], out, torch.zeros_like(out))
