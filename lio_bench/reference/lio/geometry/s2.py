"""S² (2-sphere) manifold for the gravity state (port of
`limovelo_tpu/geometry/s2.py`).

g ⊞ δ = Exp(B(g) δ) · g with B(g) ∈ ℝ^{3×2} an orthonormal basis of the
tangent plane at g, chosen deterministically from the axis least aligned
with g.
"""

from __future__ import annotations

import torch

from . import so3


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def basis(g: torch.Tensor) -> torch.Tensor:
    """Orthonormal tangent basis B(g) ∈ ℝ^{…,3,2} at g (g need not be unit)."""
    n = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-30)
    ax = torch.abs(n)
    e = torch.eye(3, dtype=n.dtype, device=n.device)
    ex, ey, ez = (e[i].expand(n.shape) for i in range(3))
    ref = torch.where(
        (ax[..., 2:3] <= ax[..., 0:1]) & (ax[..., 2:3] <= ax[..., 1:2]),
        ez,
        torch.where(ax[..., 0:1] <= ax[..., 1:2], ex, ey),
    )
    b1 = _cross(n, ref)
    b1 = b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-30)
    b2 = _cross(n, b1)
    return torch.stack([b1, b2], dim=-1)


def boxplus(g: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """g ⊞ δ = Exp(B(g) δ) g;  δ ∈ ℝ²."""
    w = (basis(g) @ delta[..., None])[..., 0]
    return (so3.exp(w) @ g[..., None])[..., 0]


def boxminus(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """g1 ⊟ g2 ∈ ℝ²: the tangent vector at g2 rotating g2 onto g1 (equal
    norms assumed, true for gravity states by construction)."""
    n1 = g1 / (torch.linalg.vector_norm(g1, dim=-1, keepdim=True) + 1e-30)
    n2 = g2 / (torch.linalg.vector_norm(g2, dim=-1, keepdim=True) + 1e-30)
    axis = _cross(n2, n1)
    s = torch.linalg.vector_norm(axis, dim=-1)
    c = torch.clamp(torch.sum(n1 * n2, dim=-1), -1.0, 1.0)
    theta = torch.atan2(s, c)
    small = s < 1e-12
    # θ/s → 1 as the directions coincide (see `transport` for its derivative)
    one = torch.ones_like(s)
    w = axis * torch.where(small, one, theta / torch.where(small, one, s))[..., None]
    return (basis(g2).transpose(-1, -2) @ w[..., None])[..., 0]


def dexp_dg(g: torch.Tensor) -> torch.Tensor:
    """∂(g ⊞ δ)/∂δ at δ=0:  −hat(g)·B(g)  ∈ ℝ^{…,3,2}."""
    return -so3.hat(g) @ basis(g)


def transport(g: torch.Tensor, g0: torch.Tensor) -> torch.Tensor:
    """∂((g ⊞ δ) ⊟ g0)/∂δ at δ=0 ∈ ℝ^{…,2,2}, the derivative of `boxminus`
    through `boxplus` written out (‖g‖ = ‖g0‖).  With n = g/‖g‖,
    u = n0 × n, s = ‖u‖, c = n0·n and θ = atan2(s, c), `boxminus` returns
    B(g0)ᵀ·u·θ/s; a tangent step moves n by T = −hat(n)·B(g), so
    du = hat(n0)·T, ds = uᵀdu/s, dc = n0ᵀT, dθ = c·ds − s·dc and
    d(θ/s) = (s·dθ − θ·ds)/s².  As the directions coincide θ/s → 1 and its
    derivative → 0, the branch `boxminus` takes below s = 1e-12."""
    n = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-30)
    n0 = g0 / (torch.linalg.vector_norm(g0, dim=-1, keepdim=True) + 1e-30)
    T = -so3.hat(n) @ basis(g)                                   # (…,3,2)
    u = _cross(n0, n)
    s = torch.linalg.vector_norm(u, dim=-1)
    c = torch.clamp(torch.sum(n0 * n, dim=-1), -1.0, 1.0)
    theta = torch.atan2(s, c)
    du = so3.hat(n0) @ T                                         # (…,3,2)
    small = s < 1e-12
    one = torch.ones_like(s)
    s_safe = torch.where(small, one, s)
    ds = (u[..., None, :] @ du)[..., 0, :] / s_safe[..., None]   # (…,2)
    dc = (n0[..., None, :] @ T)[..., 0, :]
    d_ratio = (s_safe[..., None] * (c[..., None] * ds - s[..., None] * dc)
               - theta[..., None] * ds) / (s_safe * s_safe)[..., None]
    ratio = torch.where(small, one, theta / s_safe)
    d_ratio = torch.where(small[..., None], torch.zeros_like(d_ratio), d_ratio)
    dw = du * ratio[..., None, None] + u[..., :, None] * d_ratio[..., None, :]
    return basis(g0).transpose(-1, -2) @ dw
