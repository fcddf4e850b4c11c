"""Pose-graph optimization on the device (port of
`limovelo_tpu/graph/posegraph.py`).

Keyframes form an SE(3) pose graph — odometry edges from the LIO chain,
loop edges from loop_closure.py — optimized by batched Gauss-Newton:

- Residual per edge (i, j) with measured relative pose (R̄, p̄), decoupled:
      r_rot   = Log(R̄ᵀ Rᵢᵀ Rⱼ)
      r_trans = R̄ᵀ (Rᵢᵀ (pⱼ − pᵢ) − p̄)
- All edge residuals and Jacobians are built in one batch, scatter-added
  into the dense 6K×6K normal matrix and solved densely (f32, as in the JAX
  package).
- The gauge is fixed by a strong prior on pose 0.
- `optimize_pose_graph_sharded` partitions the edges over the ranks of a
  mesh (parallel/sharding.py): each rank builds its edges' share of the
  normal equations, and Hd, bd and the cost are all-reduced every
  iteration; the dense solve runs replicated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import so3


@dataclass
class PoseGraph:
    """Host-side edge container; tensors are built on demand for the solver."""

    edges_i: List[int] = field(default_factory=list)
    edges_j: List[int] = field(default_factory=list)
    rel_R: List[np.ndarray] = field(default_factory=list)
    rel_p: List[np.ndarray] = field(default_factory=list)
    weights: List[float] = field(default_factory=list)

    def add_edge(self, i: int, j: int, R_ij: np.ndarray, p_ij: np.ndarray, weight: float = 1.0):
        self.edges_i.append(int(i))
        self.edges_j.append(int(j))
        self.rel_R.append(np.asarray(R_ij, np.float32))
        self.rel_p.append(np.asarray(p_ij, np.float32))
        self.weights.append(float(weight))

    def add_odometry_chain(self, Rs: np.ndarray, ps: np.ndarray, weight: float = 1.0):
        """Consecutive edges from an odometry trajectory (K,3,3),(K,3)."""
        for k in range(len(ps) - 1):
            R_ij = Rs[k].T @ Rs[k + 1]
            p_ij = Rs[k].T @ (ps[k + 1] - ps[k])
            self.add_edge(k, k + 1, R_ij, p_ij, weight)

    def arrays(self, device="cuda"):
        dev = resolve_device(device)
        T = lambda a: torch.as_tensor(a).to(dev)
        return (
            T(np.asarray(self.edges_i, np.int64)),
            T(np.asarray(self.edges_j, np.int64)),
            T(np.stack(self.rel_R)),
            T(np.stack(self.rel_p)),
            T(np.asarray(self.weights, np.float32)),
        )


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _edge_residuals_jacobians(Rs, ps, ei, ej, rel_R, rel_p):
    """Batched residuals (E,6) and Jacobian blocks (E,6,6) for i and j.

    Error convention: R ⊞ δθ = R·Exp(δθ), p ⊞ δp = p + δp; first-order
    Jacobians (exact at r→0)."""
    Ri, Rj = Rs[ei], Rs[ej]                        # (E,3,3)
    pi, pj = ps[ei], ps[ej]
    RiT = Ri.transpose(-1, -2)
    RbT = rel_R.transpose(-1, -2)

    R_err = RbT @ (RiT @ Rj)
    r_rot = so3.log(R_err)                         # (E,3)
    d = _mv(RiT, pj - pi)                          # Rᵢᵀ(pⱼ−pᵢ)
    r_tr = _mv(RbT, d - rel_p)

    E = ei.shape[0]
    Z = torch.zeros((E, 3, 3), dtype=Rs.dtype, device=Rs.device)

    # Rⱼ ← RⱼExp(δ):  ∂r/∂δθⱼ = Jr⁻¹(r)
    # Rᵢ ← RᵢExp(δ):  ∂r/∂δθᵢ = −Jr⁻¹(r)(RᵢᵀRⱼ)ᵀ
    # (the JAX package writes Jr⁻¹(r) as left_jacobian_inv(−r): the same
    # formula)
    Jr_inv = so3.right_jacobian_inv(r_rot)
    J_rot_j = Jr_inv
    J_rot_i = -Jr_inv @ (RiT @ Rj).transpose(-1, -2)

    # δp is additive in the world frame: ∂r_tr/∂δpⱼ = R̄ᵀRᵢᵀ = −∂r_tr/∂δpᵢ
    A = RbT @ RiT
    # ∂r_tr/∂δθᵢ: d(Rᵢᵀ)(pⱼ−pᵢ) = −δθ×(Rᵢᵀ(pⱼ−pᵢ)) ⇒ R̄ᵀ·hat(d)
    J_tr_ti = RbT @ so3.hat(d)

    # state order per pose: [δp(3), δθ(3)]
    Ji = torch.cat([torch.cat([-A, J_tr_ti], dim=-1),
                    torch.cat([Z, J_rot_i], dim=-1)], dim=-2)
    Jj = torch.cat([torch.cat([A, Z], dim=-1),
                    torch.cat([Z, J_rot_j], dim=-1)], dim=-2)
    r = torch.cat([r_tr, r_rot], dim=-1)           # (E,6)
    return r, Ji, Jj


def _build_normal_equations(Rs, ps, ei, ej, rel_R, rel_p, w, K: int):
    """Dense GN normal equations from an edge batch: (Hd (6K,6K), bd (6K),
    cost ()), an exact sum over the edges."""
    r, Ji, Jj = _edge_residuals_jacobians(Rs, ps, ei, ej, rel_R, rel_p)
    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]

    H = torch.zeros((K, K, 6, 6), dtype=Rs.dtype, device=Rs.device)
    b = torch.zeros((K, 6), dtype=Rs.dtype, device=Rs.device)
    JiTJi = wJi.transpose(-1, -2) @ Ji
    JjTJj = wJj.transpose(-1, -2) @ Jj
    JiTJj = wJi.transpose(-1, -2) @ Jj
    H.index_put_((ei, ei), JiTJi, accumulate=True)
    H.index_put_((ej, ej), JjTJj, accumulate=True)
    H.index_put_((ei, ej), JiTJj, accumulate=True)
    H.index_put_((ej, ei), JiTJj.transpose(-1, -2), accumulate=True)
    b.index_put_((ei,), _mv(wJi.transpose(-1, -2), r), accumulate=True)
    b.index_put_((ej,), _mv(wJj.transpose(-1, -2), r), accumulate=True)

    Hd = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    bd = b.reshape(6 * K)
    cost = torch.sum(r * r * w[:, None])
    return Hd, bd, cost


def _apply_gn_step(Rs, ps, Hd, bd, K: int):
    """Gauge prior on pose 0 + Levenberg damping, dense solve, manifold ⊞."""
    prior = torch.zeros(6 * K, dtype=Rs.dtype, device=Rs.device)
    prior[:6] = 1e6
    prior = prior + 1e-6
    delta = -torch.linalg.solve(Hd + torch.diag(prior), bd).reshape(K, 6)
    ps_new = ps + delta[:, :3]
    Rs_new = Rs @ so3.exp(delta[:, 3:])
    return Rs_new, ps_new


def optimize_pose_graph(graph: PoseGraph, Rs0: np.ndarray, ps0: np.ndarray, iters: int = 10,
                        device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimize the poses from their initial guesses on `device`; returns
    (Rs, ps, cost per iteration) as numpy arrays."""
    dev = resolve_device(device)
    ei, ej, rel_R, rel_p, w = graph.arrays(dev)
    Rs = torch.as_tensor(np.asarray(Rs0, np.float32)).to(dev)
    ps = torch.as_tensor(np.asarray(ps0, np.float32)).to(dev)
    K = len(ps0)
    costs = []
    for _ in range(iters):
        Hd, bd, cost = _build_normal_equations(Rs, ps, ei, ej, rel_R, rel_p, w, K)
        Rs, ps = _apply_gn_step(Rs, ps, Hd, bd, K)
        costs.append(cost)
    return Rs.cpu().numpy(), ps.cpu().numpy(), torch.stack(costs).cpu().numpy()


def make_sharded_solver(mesh, num_poses: int, iters: int = 10):
    """The edge-sharded Gauss-Newton: a function of (Rs, ps, and this rank's
    edges ei, ej, rel_R, rel_p, w) that returns (Rs, ps, cost per
    iteration) on every rank.  Each iteration all-reduces the rank's
    (Hd, bd, cost) in one collective: the sum over edges is exact, and with
    landmark-free edges the Schur complement is the plain sum."""
    K = num_poses

    def solve(Rs, ps, ei, ej, rel_R, rel_p, w):
        costs = []
        n = 6 * K
        for _ in range(iters):
            Hd, bd, cost = _build_normal_equations(Rs, ps, ei, ej, rel_R, rel_p, w, K)
            red = mesh.psum(torch.cat([Hd.reshape(-1), bd, cost.reshape(1)]))
            Hd, bd, cost = red[:n * n].reshape(n, n), red[n * n:n * n + n], red[-1]
            Rs, ps = _apply_gn_step(Rs, ps, Hd, bd, K)
            costs.append(cost)
        return Rs, ps, torch.stack(costs)

    return solve


def optimize_pose_graph_sharded(graph: PoseGraph, Rs0: np.ndarray, ps0: np.ndarray, mesh,
                                iters: int = 10) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The edge-sharded entry point (every rank of `mesh` calls it with the
    same graph): the edge list is padded to a multiple of the world size
    with zero-weight identity edges (exact no-ops in the sum), each rank
    takes its contiguous block, and the solve runs on the mesh's device.
    Returns (Rs, ps, cost per iteration) as numpy arrays, alike on every
    rank."""
    ei = np.asarray(graph.edges_i, np.int64)
    ej = np.asarray(graph.edges_j, np.int64)
    rel_R = np.stack(graph.rel_R).astype(np.float32)
    rel_p = np.stack(graph.rel_p).astype(np.float32)
    w = np.asarray(graph.weights, np.float32)
    pad = (-len(w)) % mesh.size
    if pad:
        ei = np.concatenate([ei, np.zeros(pad, np.int64)])
        ej = np.concatenate([ej, np.zeros(pad, np.int64)])
        rel_R = np.concatenate([rel_R, np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))])
        rel_p = np.concatenate([rel_p, np.zeros((pad, 3), np.float32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    per = len(w) // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(mesh.device)
    solver = make_sharded_solver(mesh, num_poses=len(ps0), iters=iters)
    Rs, ps, costs = solver(T(np.asarray(Rs0, np.float32)), T(np.asarray(ps0, np.float32)),
                           T(ei[mine]), T(ej[mine]), T(rel_R[mine]), T(rel_p[mine]), T(w[mine]))
    return Rs.cpu().numpy(), ps.cpu().numpy(), costs.cpu().numpy()
