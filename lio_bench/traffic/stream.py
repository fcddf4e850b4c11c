"""The benchmark's sensor stream: a standing-start ramp and one lap of a
closed course, rendered once from the seed, then the lap replayed without
end, each replay shifted by the lap period.

Messages come in the order a live node receives them (the order of
`limovelo_tpu_torch/io/simulate.replay_into`): before each scan the IMU
samples up to the scan's last point, then the scan; a segment's IMU tail
after its last scan precedes the next segment's first scan.  A message is
`("imu", (t, a, w))` or `("scan", (xyz, rel, stamp, intensity))`, the scan
as a Velodyne driver stamps it: per-point times relative to the rotation
(from its start with `offset_beginning`, else from its end) and a header
stamp at the rotation's start (`stamp_beginning`) or end.

The rays are cast in PyTorch on the given device from one `torch.Generator`
seeded with the run's seed (range and IMU noise); the world and the course
come from the configuration alone, so every seed drives the same geometry.
A configuration's `course.kind` and `scene.kind` name a module of this
package (`ring.py`, `room.py`) whose `make(spec)` builds it: a course gives
`lap_s`, `lap_start_s` and the pose and its derivatives at given times, a
world gives `caster(device)`.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch


#: rays cast per device call while rendering
_RAYS_PER_CALL = 1 << 21


class Scan(NamedTuple):
    xyz: np.ndarray        # (N,3) float32, LiDAR frame
    rel: np.ndarray        # (N,) float64, Velodyne per-point time field
    stamp: float           # header stamp
    intensity: np.ndarray  # (N,) float32
    end: float             # absolute time of the last point


@dataclass
class Segment:
    imu_t: np.ndarray      # (M,) float64
    imu_a: np.ndarray      # (M,3) float32
    imu_w: np.ndarray      # (M,3) float32
    scans: List[Scan]
    order: List[Tuple[int, int]]   # (0, imu index) or (1, scan index), in feed order


@dataclass
class SensorFrame:
    """What the rendering takes from the sensor's profile."""

    rotation_s: float
    imu_rate: float
    gravity: Tuple[float, float, float]   # g in the world (the filter's gravity_vec)
    R_LI: np.ndarray                      # (3,3) LiDAR → IMU
    t_LI: np.ndarray                      # (3,)
    offset_beginning: bool
    stamp_beginning: bool


def build(spec: dict):
    """The course or world that `spec["kind"]` names."""
    return importlib.import_module(f"{__package__}.{spec['kind']}").make(spec)


def seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


class Stream:
    """The ramp, then lap 0, 1, 2, ... of the same rendered lap."""

    def __init__(self, ramp: Segment, lap: Segment, lap_s: float):
        self.ramp, self.lap, self.lap_s = ramp, lap, lap_s

    @property
    def ramp_messages(self) -> int:
        return len(self.ramp.order)

    @property
    def lap_messages(self) -> int:
        return len(self.lap.order)

    def message(self, m: int):
        """The m-th message of the stream (0-based)."""
        if m < self.ramp_messages:
            seg, shift = self.ramp, 0.0
            kind, i = seg.order[m]
        else:
            k, r = divmod(m - self.ramp_messages, self.lap_messages)
            seg, shift = self.lap, k * self.lap_s
            kind, i = seg.order[r]
        if kind == 0:
            return "imu", (seg.imu_t[i] + shift, seg.imu_a[i], seg.imu_w[i])
        s = seg.scans[i]
        return "scan", (s.xyz, s.rel, s.stamp + shift, s.intensity)

    def points_per_scan(self) -> float:
        return float(np.mean([len(s.xyz) for s in self.lap.scans]))


def _feed_order(imu_t: np.ndarray, scans: List[Scan]) -> List[Tuple[int, int]]:
    order, ii = [], 0
    for j, s in enumerate(scans):
        while ii < len(imu_t) and imu_t[ii] <= s.end:
            order.append((0, ii))
            ii += 1
        order.append((1, j))
    order.extend((0, i) for i in range(ii, len(imu_t)))
    return order


def _beam_dirs(sensor: dict) -> np.ndarray:
    """(azimuths, beams, 3) unit rays in the LiDAR frame, counter-clockwise
    from +x, beams from the lowest elevation up."""
    lo, hi = sorted(sensor["elevation_deg"])
    elev = np.deg2rad(np.linspace(lo, hi, int(sensor["beams"])))
    az = np.linspace(0, 2 * np.pi, int(sensor["azimuths"]), endpoint=False)
    return np.stack([np.cos(elev)[None, :] * np.cos(az)[:, None],
                     np.cos(elev)[None, :] * np.sin(az)[:, None],
                     np.broadcast_to(np.sin(elev)[None, :], (len(az), len(elev)))], axis=-1)


def _render_scans(starts: np.ndarray, path, cast, sensor: dict, frame: SensorFrame,
                  gen: torch.Generator, device) -> List[Scan]:
    dirs = _beam_dirs(sensor)
    C, L = dirs.shape[:2]
    rot = frame.rotation_s
    col_frac = np.arange(C) / C * rot
    dirs_d = torch.as_tensor(dirs, dtype=torch.float64, device=device)
    max_range = float(sensor["max_range_m"])
    noise_m = float(sensor["range_noise_m"])
    per_call = max(1, _RAYS_PER_CALL // (C * L))
    scans = []
    for c0 in range(0, len(starts), per_call):
        t0 = starts[c0:c0 + per_call]
        S = len(t0)
        col_t = t0[:, None] + col_frac[None, :]                          # (S,C)
        R_b = path.rotation(col_t.reshape(-1))
        p_b = path.position(col_t.reshape(-1))
        R_wl = torch.as_tensor(R_b @ frame.R_LI, device=device).reshape(S, C, 3, 3)
        p_wl = torch.as_tensor(R_b @ frame.t_LI + p_b, device=device).reshape(S, C, 1, 3)
        d_w = torch.einsum("scij,clj->scli", R_wl, dirs_d)                # (S,C,L,3)
        org = p_wl.expand(S, C, L, 3)
        rng = cast(org.reshape(-1, 3), d_w.reshape(-1, 3)).reshape(S, C, L)
        noise = torch.randn((S, C, L), generator=gen, dtype=torch.float64, device=device)
        ok = torch.isfinite(rng) & (rng < max_range)
        r = torch.where(ok, rng + noise * noise_m, torch.ones_like(rng))
        xyz = (dirs_d[None] * r[..., None]).to(torch.float32).cpu().numpy()
        inten = (100.0 / torch.clamp(r, min=1.0) ** 2).to(torch.float32).cpu().numpy()
        ok = ok.cpu().numpy()
        for s in range(S):
            sel = ok[s].reshape(-1)
            t = np.repeat(col_t[s], L)[sel]
            rel = t - t0[s] if frame.offset_beginning else t - t0[s] - rot
            end = float(t[-1]) if len(t) else float(t0[s])
            stamp = float(t[0] if frame.stamp_beginning else t[-1]) if len(t) else float(t0[s])
            scans.append(Scan(xyz[s].reshape(-1, 3)[sel], rel, stamp,
                              inten[s].reshape(-1)[sel], end))
    return scans


def _render_imu(t: np.ndarray, path, sensor: dict, frame: SensorFrame,
                gen: torch.Generator, device):
    R_b = path.rotation(t)
    g = np.asarray(frame.gravity, np.float64)
    spec = np.einsum("nji,nj->ni", R_b, path.acceleration(t) - g)
    noise = torch.randn((len(t), 6), generator=gen, dtype=torch.float64,
                        device=device).cpu().numpy()
    a = spec + np.asarray(sensor["accel_bias"]) + noise[:, :3] * float(sensor["accel_noise"])
    w = (path.body_rate(t) + np.asarray(sensor["gyro_bias"])
         + noise[:, 3:] * float(sensor["gyro_noise"]))
    return a.astype(np.float32), w.astype(np.float32)


def _segment(t_start: float, duration: float, path, cast, sensor: dict,
             frame: SensorFrame, gen: torch.Generator, device) -> Segment:
    n_scans = int(round(duration / frame.rotation_s))
    n_imu = int(round(duration * frame.imu_rate))
    starts = t_start + np.arange(n_scans) * frame.rotation_s
    scans = _render_scans(starts, path, cast, sensor, frame, gen, device)
    imu_t = t_start + (np.arange(n_imu) + 1) / frame.imu_rate
    a, w = _render_imu(imu_t, path, sensor, frame, gen, device)
    return Segment(imu_t, a, w, scans, _feed_order(imu_t, scans))


def check_lap(path, frame: SensorFrame) -> None:
    """A lap must hold whole rotations and whole IMU periods, and start
    where the ramp ends on both clocks."""
    for what, period in (("rotation", frame.rotation_s), ("IMU period", 1.0 / frame.imu_rate)):
        for name, v in (("lap", path.lap_s), ("ramp", path.lap_start_s)):
            n = v / period
            if abs(n - round(n)) > 1e-6 or round(n) < 1:
                raise ValueError(f"the {name} ({v} s) is not a whole number of the {what} "
                                 f"({period} s)")


def render(sensor: dict, scene: dict, course: dict, frame: SensorFrame, seed: int,
           device) -> Stream:
    """Render the ramp (standing start to the lap speed) and one lap."""
    path = build(course)
    check_lap(path, frame)
    cast = build(scene).caster(device)
    gen = seed_generator(seed, device)
    ramp = _segment(0.0, path.lap_start_s, path, cast, sensor, frame, gen, device)
    lap = _segment(path.lap_start_s, path.lap_s, path, cast, sensor, frame, gen, device)
    return Stream(ramp, lap, path.lap_s)
