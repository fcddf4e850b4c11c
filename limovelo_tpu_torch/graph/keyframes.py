"""Keyframe selection and storage (a copy of `limovelo_tpu/graph/keyframes.py`,
which the port must not import; numpy and scipy only).

Keyframes anchor the pose graph (posegraph.py) and feed loop closure
(loop_closure.py).  The reference keeps none: its map is one unbounded
point cloud and it closes no loops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from scipy.spatial.transform import Rotation as Rsc


@dataclass
class Keyframe:
    kf_id: int
    t: float
    R: np.ndarray            # (3,3) world←body at creation
    p: np.ndarray            # (3,)
    scan: np.ndarray         # (M,3) downsampled scan, LiDAR frame
    # pose after graph optimization (init = odometry pose)
    R_opt: np.ndarray = None
    p_opt: np.ndarray = None

    def __post_init__(self):
        if self.R_opt is None:
            self.R_opt = self.R.copy()
        if self.p_opt is None:
            self.p_opt = self.p.copy()


class KeyframeSelector:
    """Distance/rotation-triggered keyframe gating (standard LIO practice)."""

    def __init__(self, min_translation: float = 2.0, min_rotation_deg: float = 15.0):
        self.min_translation = min_translation
        self.min_rotation = np.deg2rad(min_rotation_deg)
        self._last_R: Optional[np.ndarray] = None
        self._last_p: Optional[np.ndarray] = None

    def should_add(self, R: np.ndarray, p: np.ndarray) -> bool:
        if self._last_R is None:
            self._accept(R, p)
            return True
        dp = np.linalg.norm(p - self._last_p)
        dr = np.linalg.norm(Rsc.from_matrix(self._last_R.T @ R).as_rotvec())
        if dp >= self.min_translation or dr >= self.min_rotation:
            self._accept(R, p)
            return True
        return False

    def _accept(self, R, p):
        self._last_R = R.copy()
        self._last_p = p.copy()


class KeyframeStore:
    def __init__(self, selector: Optional[KeyframeSelector] = None):
        self.selector = selector or KeyframeSelector()
        self.frames: List[Keyframe] = []

    def maybe_add(self, t: float, R: np.ndarray, p: np.ndarray, scan: np.ndarray) -> Optional[Keyframe]:
        if not self.selector.should_add(R, p):
            return None
        return self.add(t, R, p, scan)

    def add(self, t: float, R: np.ndarray, p: np.ndarray, scan: np.ndarray) -> Keyframe:
        """Unconditional append — for callers that gated on
        `selector.should_add` themselves BEFORE materializing `scan` (pulling
        a scan off-device is expensive; gate first, fetch second)."""
        kf = Keyframe(kf_id=len(self.frames), t=t, R=R.copy(), p=p.copy(), scan=scan)
        self.frames.append(kf)
        return kf

    def positions(self, optimized: bool = True) -> np.ndarray:
        if not self.frames:
            return np.zeros((0, 3))
        return np.stack([f.p_opt if optimized else f.p for f in self.frames])

    def __len__(self):
        return len(self.frames)
