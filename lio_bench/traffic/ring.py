"""A closed circular course driven at constant speed after a standing
start (`course.kind = "ring"`): a frozen copy of `circle_trajectory` and its
standing-start ramp in `limovelo_tpu_torch/io/simulate.py`, evaluated for
many times at once (numpy, float64)."""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
from scipy.spatial.transform import Rotation as Rsc

#: central-difference step of the IMU's derivatives (io/simulate.Trajectory.eps)
EPS = 1e-4


def ramped_distance(t: np.ndarray, ramp: float, hold: float) -> np.ndarray:
    """∫₀ᵗ smoothstep((τ−hold)/ramp) dτ: the vehicle stands for `hold`
    seconds, then its speed ramps from 0 to 1 over `ramp` seconds (C²)."""
    t = np.asarray(t, np.float64) - hold
    if ramp <= 0.0:
        return np.maximum(t, 0.0)
    u = np.clip(t / ramp, 0.0, 1.0)
    inside = ramp * (u ** 3 - u ** 4 / 2.0)
    return np.where(t <= 0.0, 0.0, np.where(t >= ramp, t - ramp / 2.0, inside))


@dataclass(frozen=True)
class Ring:
    """A closed circular course driven at constant speed after a standing
    start: after `hold_s + ramp_s` the motion repeats every `lap_s` seconds
    (the yaw gains 2π a lap), so one rendered lap can be replayed."""

    radius_m: float
    lap_s: float
    height_m: float
    hold_s: float
    ramp_s: float
    sway_rad: float = 0.0

    @property
    def omega(self) -> float:
        return 2.0 * np.pi / self.lap_s

    @property
    def speed_mps(self) -> float:
        return self.radius_m * self.omega

    @property
    def lap_start_s(self) -> float:
        return self.hold_s + self.ramp_s

    def _s(self, t):
        return ramped_distance(t, self.ramp_s, self.hold_s)

    def position(self, t) -> np.ndarray:
        s = self._s(t)
        r, w = self.radius_m, self.omega
        return np.stack([r * np.cos(w * s) - r, r * np.sin(w * s),
                         np.full_like(s, self.height_m)], axis=-1)

    def rotation(self, t) -> np.ndarray:
        s = self._s(t)
        yaw = self.omega * s + np.pi / 2
        if self.sway_rad <= 0.0:
            return Rsc.from_euler("z", yaw[:, None]).as_matrix()
        roll = self.sway_rad * np.sin(2.3 * s)
        pitch = 0.6 * self.sway_rad * np.sin(1.7 * s + 0.8)
        return Rsc.from_euler("zyx", np.stack([yaw, pitch, roll], axis=-1)).as_matrix()

    def acceleration(self, t) -> np.ndarray:
        t = np.asarray(t, np.float64)
        return (self.position(t + EPS) - 2 * self.position(t)
                + self.position(t - EPS)) / (EPS * EPS)

    def velocity(self, t) -> np.ndarray:
        t = np.asarray(t, np.float64)
        return (self.position(t + EPS) - self.position(t - EPS)) / (2 * EPS)

    def body_rate(self, t) -> np.ndarray:
        """ω = Log(R(t−e)ᵀ R(t+e)) / 2e, in the body frame."""
        t = np.asarray(t, np.float64)
        R0, R1 = self.rotation(t - EPS), self.rotation(t + EPS)
        return Rsc.from_matrix(np.einsum("nji,njk->nik", R0, R1)).as_rotvec() / (2 * EPS)


def make(course: dict) -> Ring:
    return Ring(**{k: course[k] for k in ("radius_m", "lap_s", "height_m", "hold_s", "ramp_s",
                                          "sway_rad") if k in course})
