"""A closed room with boxes (`scene.kind = "room"`): a frozen copy of
`room_world` in `limovelo_tpu_torch/io/simulate.py`, with its ray caster in
PyTorch on any device (float64)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Room:
    """A room of `size` × `size` × `height` metres with `n_boxes` random
    boxes (io/simulate.room_world, the same boxes for the same `seed`)."""

    size: float
    height: float
    n_boxes: int
    seed: int

    def planes(self) -> List[Tuple[np.ndarray, float]]:
        s, h = self.size, self.height
        return [
            (np.array([0.0, 0.0, 1.0]), 0.0),
            (np.array([0.0, 0.0, -1.0]), h),
            (np.array([1.0, 0.0, 0.0]), s / 2),
            (np.array([-1.0, 0.0, 0.0]), s / 2),
            (np.array([0.0, 1.0, 0.0]), s / 2),
            (np.array([0.0, -1.0, 0.0]), s / 2),
        ]

    def boxes(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        out = []
        for _ in range(self.n_boxes):
            c = rng.uniform(-self.size / 2 + 2, self.size / 2 - 2, size=2)
            if np.linalg.norm(c) < 3.0:  # keep the trajectory region clear
                c = c / np.linalg.norm(c) * 3.5
            half = rng.uniform(0.4, 1.2, size=3)
            out.append((np.array([c[0], c[1], half[2]]), half))
        return out

    def caster(self, device):
        """(origins (N,3), dirs (N,3)) float64 tensors → ranges (N,), +inf
        where nothing is hit."""
        f64 = dict(dtype=torch.float64, device=device)
        planes = [(torch.as_tensor(n, **f64), float(d)) for n, d in self.planes()]
        boxes = [(torch.as_tensor(c - h, **f64), torch.as_tensor(c + h, **f64))
                 for c, h in self.boxes()]

        def cast(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
            inf = torch.full(origins.shape[:1], float("inf"), **f64)
            best = inf.clone()
            for n, d in planes:
                denom = dirs @ n
                safe = torch.where(denom.abs() > 1e-9, denom, torch.full_like(denom, float("nan")))
                tt = -(origins @ n + d) / safe
                tt = torch.where((tt > 0.05) & torch.isfinite(tt), tt, inf)
                best = torch.minimum(best, tt)
            inv = 1.0 / torch.where(dirs.abs() > 1e-9, dirs, torch.full_like(dirs, 1e-9))
            for lo, hi in boxes:
                t0 = (lo - origins) * inv
                t1 = (hi - origins) * inv
                tmin = torch.minimum(t0, t1).amax(dim=1)
                tmax = torch.maximum(t0, t1).amin(dim=1)
                hit = (tmax > tmin) & (tmin > 0.05)
                best = torch.minimum(best, torch.where(hit, tmin, inf))
            return best

        return cast


def make(scene: dict) -> Room:
    return Room(size=scene["size_m"], height=scene["height_m"], n_boxes=scene["n_boxes"],
                seed=scene["seed"])
