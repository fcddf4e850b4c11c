"""Synthetic LiDAR+IMU simulator with ground truth (a copy of
`limovelo_tpu/io/simulate.py`, which the port must not import).

The reference project validates purely by replaying rosbags and eyeballing
rviz (SURVEY.md §4).  We need deterministic, dataset-free validation: this
module builds a planar world (a room with boxes — rich planar structure, like
the environments the estimator is designed for), drives a smooth trajectory
through it, and renders spinning-LiDAR scans with per-point timestamps plus
ideal/noisy IMU samples.  Ground truth poses make ATE computable exactly.

Conventions match the pipeline: IMU accelerometer measures specific force
a = Rᵀ(v̇ − g_world) + bias + noise with g_world = config.gravity_vec
(so at rest a = −Rᵀ g_world); gyro measures body rates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as Rsc


@dataclass
class SimScan:
    """One LiDAR rotation: points in the sensor frame with absolute stamps."""

    pts: np.ndarray      # (N,3) float32, LiDAR frame at each point's own time
    t: np.ndarray        # (N,) float64 absolute
    stamp: float         # scan header stamp (beginning of rotation)
    intensity: np.ndarray = None  # (N,) float32 per-point return intensity


@dataclass
class SimData:
    scans: List[SimScan]
    imu_t: np.ndarray    # (M,) float64
    imu_a: np.ndarray    # (M,3) float32
    imu_w: np.ndarray    # (M,3) float32
    gt_t: np.ndarray     # (K,) float64 dense ground-truth sampling
    gt_R: np.ndarray     # (K,3,3)
    gt_p: np.ndarray     # (K,3)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


def corridor_world(
    length: float = 60.0,
    width: float = 6.0,
    height: float = 4.0,
    pillar_every: float = 8.0,
    pillar_inset: float = 1.2,
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Axis-aligned corridor along +x: floor, ceiling, two walls, end caps,
    plus free-standing columns every `pillar_every` m, `pillar_inset` m in
    from the walls.  A bare corridor is longitudinally degenerate (nothing
    constrains x but the far end caps); the columns make x observable, as
    real corridors' doorframes and columns do.  They stand clear of the
    walls: a flush column's x-face points all sit within a 5-NN radius of
    the wall junction, whose fitted pseudo-planes carry a motion-correlated
    bias.  Returns a ray-caster: (origins (N,3), dirs (N,3)) → ranges (N,)."""

    planes = [
        # (normal, offset): n·x + d = 0, rays hit from inside
        (np.array([0.0, 0.0, 1.0]), 0.0),         # floor z=0
        (np.array([0.0, 0.0, -1.0]), height),     # ceiling z=h
        (np.array([0.0, 1.0, 0.0]), width / 2),   # wall y=-w/2
        (np.array([0.0, -1.0, 0.0]), width / 2),  # wall y=+w/2
        (np.array([1.0, 0.0, 0.0]), 10.0),        # cap x=-10
        (np.array([-1.0, 0.0, 0.0]), length),     # cap x=length
    ]
    boxes = []
    if pillar_every > 0:
        x = 0.0
        side = 1.0
        while x < length:
            y = side * (width / 2 - pillar_inset)
            boxes.append((np.array([x, y, height / 2]), np.array([0.3, 0.3, height / 2])))
            side = -side
            x += pillar_every

    def cast(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        best = np.full(len(origins), np.inf)
        for n, d in planes:
            denom = dirs @ n
            tt = -(origins @ n + d) / np.where(np.abs(denom) > 1e-9, denom, np.nan)
            tt = np.where((tt > 0.05) & np.isfinite(tt), tt, np.inf)
            best = np.minimum(best, tt)
        for c, half in boxes:
            lo, hi = c - half, c + half
            inv = 1.0 / np.where(np.abs(dirs) > 1e-9, dirs, 1e-9)
            t0 = (lo[None] - origins) * inv
            t1 = (hi[None] - origins) * inv
            tmin = np.minimum(t0, t1).max(axis=1)
            tmax = np.maximum(t0, t1).min(axis=1)
            hit = (tmax > tmin) & (tmin > 0.05)
            best = np.minimum(best, np.where(hit, tmin, np.inf))
        return best

    return cast


def room_world(size: float = 20.0, height: float = 5.0, n_boxes: int = 8, seed: int = 3):
    """A big room with random boxes — more geometric variety (corners)."""
    rng = np.random.default_rng(seed)
    planes = [
        (np.array([0.0, 0.0, 1.0]), 0.0),
        (np.array([0.0, 0.0, -1.0]), height),
        (np.array([1.0, 0.0, 0.0]), size / 2),
        (np.array([-1.0, 0.0, 0.0]), size / 2),
        (np.array([0.0, 1.0, 0.0]), size / 2),
        (np.array([0.0, -1.0, 0.0]), size / 2),
    ]
    boxes = []
    for _ in range(n_boxes):
        c = rng.uniform(-size / 2 + 2, size / 2 - 2, size=2)
        if np.linalg.norm(c) < 3.0:  # keep the trajectory region clear
            c = c / np.linalg.norm(c) * 3.5
        half = rng.uniform(0.4, 1.2, size=3)
        boxes.append((np.array([c[0], c[1], half[2]]), half))

    def cast(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        best = np.full(len(origins), np.inf)
        for n, d in planes:
            denom = dirs @ n
            tt = -(origins @ n + d) / np.where(np.abs(denom) > 1e-9, denom, np.nan)
            tt = np.where((tt > 0.05) & np.isfinite(tt), tt, np.inf)
            best = np.minimum(best, tt)
        for c, half in boxes:
            lo, hi = c - half, c + half
            inv = 1.0 / np.where(np.abs(dirs) > 1e-9, dirs, 1e-9)
            t0 = (lo[None] - origins) * inv
            t1 = (hi[None] - origins) * inv
            tmin = np.minimum(t0, t1).max(axis=1)
            tmax = np.maximum(t0, t1).min(axis=1)
            hit = (tmax > tmin) & (tmin > 0.05)
            best = np.minimum(best, np.where(hit, tmin, np.inf))
        return best

    return cast


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


class Trajectory:
    """Smooth analytic trajectory: position + yaw (+ optional roll/pitch)
    splines with exact derivatives (so IMU measurements are consistent with
    ground truth).

    `rp_fn(t) → (roll, pitch)`: body roll/pitch on top of yaw — suspension
    motion.  Extrinsic-translation observability NEEDS it: under yaw-only
    rotation the z-row of R·t_LI never changes, so t_LI_z is structurally
    unobservable however long the run (the real car's banking/pitching is
    what excites it)."""

    def __init__(self, pos_fn, yaw_fn, eps: float = 1e-4, rp_fn=None):
        self.pos_fn = pos_fn
        self.yaw_fn = yaw_fn
        self.eps = eps
        self.rp_fn = rp_fn

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        if self.rp_fn is None:
            R = Rsc.from_euler("z", self.yaw_fn(t)).as_matrix()
        else:
            roll, pitch = self.rp_fn(t)
            R = Rsc.from_euler("zyx", [self.yaw_fn(t), pitch, roll]).as_matrix()
        return R, self.pos_fn(t)

    def vel(self, t: float) -> np.ndarray:
        e = self.eps
        return (self.pos_fn(t + e) - self.pos_fn(t - e)) / (2 * e)

    def acc(self, t: float) -> np.ndarray:
        e = self.eps
        return (self.pos_fn(t + e) - 2 * self.pos_fn(t) + self.pos_fn(t - e)) / (e * e)

    def omega_body(self, t: float) -> np.ndarray:
        # general body rate from the orientation path: ω = Log(R(t−e)ᵀR(t+e))/2e
        e = self.eps
        R0, _ = self.pose(t - e)
        R1, _ = self.pose(t + e)
        return Rsc.from_matrix(R0.T @ R1).as_rotvec() / (2 * e)


def _ramped_distance(t: float, ramp: float, hold: float = 0.0) -> float:
    """∫₀ᵗ smoothstep((τ−hold)/ramp) dτ — C² standing-start profile: the car
    sits still for `hold` seconds, then velocity ramps 0→1 over `ramp`
    seconds (the racing reality: the filter initializes at rest like the car
    does; README.md:19-20's 20 m/s is reached, not teleported into).  The
    hold matters: the estimator's readiness gate buffers ~2·real_time_delay
    of IMU before initializing (Accumulator.cpp:154-156), and it seeds v=0 —
    a launch already in progress at t0 would hand it a wrong initial
    velocity no real dataset has.  ramp=0 → step to full speed after hold."""
    t = t - hold
    if ramp <= 0.0:
        return max(t, 0.0)
    if t <= 0.0:
        return 0.0
    if t >= ramp:
        return t - ramp / 2.0
    u = t / ramp
    return ramp * (u ** 3 - u ** 4 / 2.0)


def corridor_trajectory(speed: float = 5.0, weave: float = 0.5,
                        ramp: float = 1.0, hold: float = 0.5) -> Trajectory:
    """Along the corridor's +x axis with a gentle weave, from a standing
    start (0.5 s hold, 1 s ramp): the filter initializes with v = 0, and a
    trajectory already at cruise speed at t = 0 would feed the motion
    compensation a wrong velocity while the map bootstraps."""
    def pos(t):
        s = _ramped_distance(t, ramp, hold)
        return np.array(
            [speed * s, weave * np.sin(0.8 * s), 1.5 + 0.1 * np.sin(1.3 * s)]
        )

    def yaw(t):
        return 0.12 * np.sin(0.5 * _ramped_distance(t, ramp, hold))

    return Trajectory(pos, yaw)


def circle_trajectory(radius: float = 5.0, omega: float = 0.5,
                      ramp: float = 1.0, hold: float = 0.5,
                      sway: float = 0.0) -> Trajectory:
    """`sway` > 0 adds suspension roll/pitch oscillation (radians) scaled by
    the ramp progress — the excitation that makes extrinsic translation
    observable (see Trajectory docstring).  The default is a standing start
    (0.5 s hold, 1 s ramp): the filter initializes with v = 0, as a vehicle
    starts at rest."""
    def pos(t):
        s = _ramped_distance(t, ramp, hold)
        return np.array(
            [radius * np.cos(omega * s) - radius, radius * np.sin(omega * s), 1.5]
        )

    def yaw(t):
        return omega * _ramped_distance(t, ramp, hold) + np.pi / 2

    rp = None
    if sway > 0.0:
        def rp(t):
            s = _ramped_distance(t, ramp, hold)
            return sway * np.sin(2.3 * s), 0.6 * sway * np.sin(1.7 * s + 0.8)

    return Trajectory(pos, yaw, rp_fn=rp)


# ---------------------------------------------------------------------------
# sensor rendering
# ---------------------------------------------------------------------------


def simulate(
    world_cast,
    traj: Trajectory,
    config,
    duration: float = 10.0,
    t_start: float = 0.0,
    lidar_lines: int = 16,
    pts_per_line: int = 256,
    imu_rate: float = 200.0,
    range_noise: float = 0.01,
    accel_noise: float = 0.02,
    gyro_noise: float = 0.002,
    accel_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    gyro_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_range: float = 80.0,
    seed: int = 0,
    azimuths: np.ndarray = None,
    extrinsics: Tuple[np.ndarray, np.ndarray] = None,
) -> SimData:
    """Render scans + IMU along the trajectory.

    LiDAR model: `lidar_lines` elevation rings, azimuth sweeping 2π per
    `config.full_rotation_time`, each column stamped at its own absolute time
    (velodyne-style per-point stamps, SURVEY.md §2.6).  The sensor frame
    equals the body frame composed with the configured LiDAR→IMU extrinsics.

    `azimuths`: optional per-column azimuth schedule (column c fires at
    t0 + c/C·rot_time toward azimuth[c]).  Default is a counter-clockwise
    0→2π sweep; the KITTI fixture writer passes the HDL-64 clockwise-from-
    the-rear sweep so the reader's azimuth-time reconstruction
    (io/kitti.py) is exercised faithfully.

    `extrinsics`: optional (R_LI, t_LI) override — used to render with TRUE
    extrinsics while the pipeline config carries a perturbed guess
    (online-extrinsics estimation tests, config/xaloc.yaml semantics).
    """
    rng = np.random.default_rng(seed)
    g_world = np.array(config.gravity_vec, np.float64)
    if extrinsics is not None:
        R_LI = np.asarray(extrinsics[0], np.float64).reshape(3, 3)
        t_LI = np.asarray(extrinsics[1], np.float64)
    else:
        R_LI = np.array(config.I_Rotation_L, np.float64).reshape(3, 3)
        t_LI = np.array(config.I_Translation_L, np.float64)

    rot_time = config.full_rotation_time
    n_scans = int(duration / rot_time)
    elev = np.deg2rad(np.linspace(-15, 15, lidar_lines))

    scans = []
    for si in range(n_scans):
        t0 = t_start + si * rot_time
        if azimuths is None:
            az = np.linspace(0, 2 * np.pi, pts_per_line, endpoint=False)
        else:
            az = np.asarray(azimuths, np.float64)
        cols = len(az)
        col_t = t0 + (np.arange(cols) / cols) * rot_time
        dirs_l = np.stack(
            [
                np.cos(elev)[None, :] * np.cos(az)[:, None],
                np.cos(elev)[None, :] * np.sin(az)[:, None],
                np.broadcast_to(np.sin(elev)[None, :], (cols, lidar_lines)),
            ],
            axis=-1,
        )  # (cols, lines, 3) in LiDAR frame
        # per-column sensor pose (body pose ∘ extrinsics), evaluated in LOCAL
        # time: epoch-scale arguments (KITTI fixtures stamp at ~1.3e9 s)
        # destroy the finite-difference IMU derivatives (f64 position
        # quantization at |p|~5e9 m amplifies to ~100 m/s² of acc noise
        # through /eps²)
        R_wl = np.empty((cols, 3, 3))
        p_wl = np.empty((cols, 3))
        for ci in range(cols):
            R_b, p_b = traj.pose(col_t[ci] - t_start)
            R_wl[ci] = R_b @ R_LI
            p_wl[ci] = R_b @ t_LI + p_b
        # the whole scan's rays in one cast, in (column, line) order; the
        # range noise is one draw over the kept returns in that order, which
        # gives the values of one draw per column
        d_w = np.matmul(dirs_l, R_wl.transpose(0, 2, 1)).reshape(-1, 3)
        ranges = world_cast(np.repeat(p_wl, lidar_lines, axis=0), d_w)
        ok = np.isfinite(ranges) & (ranges < max_range)
        r = ranges[ok] + rng.normal(size=int(ok.sum())) * range_noise
        # deterministic per-return intensity (1/r² falloff, arbitrary
        # albedo scale) — exercises the intensity channel end to end
        scans.append(
            SimScan(
                pts=(dirs_l.reshape(-1, 3)[ok] * r[:, None]).astype(np.float32),
                t=np.repeat(col_t, ok.reshape(cols, lidar_lines).sum(axis=1)),
                stamp=t0,
                intensity=(100.0 / np.maximum(r, 1.0) ** 2).astype(np.float32),
            )
        )

    # IMU
    m = int(duration * imu_rate)
    imu_t = t_start + (np.arange(m) + 1) / imu_rate
    imu_a = np.zeros((m, 3), np.float32)
    imu_w = np.zeros((m, 3), np.float32)
    for i, t in enumerate(imu_t):
        tl = t - t_start            # local time — see the render-loop note
        R_b, _ = traj.pose(tl)
        a_spec = R_b.T @ (traj.acc(tl) - g_world)
        imu_a[i] = a_spec + np.array(accel_bias) + rng.normal(size=3) * accel_noise
        imu_w[i] = traj.omega_body(tl) + np.array(gyro_bias) + rng.normal(size=3) * gyro_noise

    # dense ground truth (absolute stamps, local-time evaluation)
    gt_t = t_start + np.linspace(0, duration, int(duration * 100) + 1)
    gt_R = np.stack([traj.pose(t - t_start)[0] for t in gt_t])
    gt_p = np.stack([traj.pose(t - t_start)[1] for t in gt_t])

    return SimData(
        scans=scans, imu_t=imu_t, imu_a=imu_a, imu_w=imu_w,
        gt_t=gt_t, gt_R=gt_R, gt_p=gt_p,
    )


def replay_into(pipe, sim: SimData, lo: int = 0, hi: Optional[int] = None,
                spin_every_imu: bool = False) -> None:
    """Stream scans [lo, hi) of sim data into a pipeline in time order (like
    a live rosbag): each scan after the IMU samples up to its last point,
    then a spin; the remaining IMU samples only with the stream's last scan.
    Feeding everything up-front would put `initial_time` at the stream's end
    (readiness fires on buffer size — Accumulator.cpp:154-156).  Feeding
    [0, k) and then [k, n) makes the same calls as one replay, so a run can
    stop at a scan boundary (to checkpoint) and go on.

    `spin_every_imu` also spins after each IMU sample, as a live main loop
    does: with `real_time` windows each sample can open a new window."""
    scans = sim.scans
    hi = len(scans) if hi is None else hi
    end = lambda scan: scan.t[-1] if len(scan.t) else scan.stamp
    m = len(sim.imu_t)

    def feed_imu(i):
        pipe.add_imu(sim.imu_t[i], sim.imu_a[i], sim.imu_w[i])
        if spin_every_imu:
            pipe.spin()

    # skip the IMU samples that the scans before `lo` took (imu_t is sorted)
    ii = 0
    if lo:
        ii = int(np.searchsorted(sim.imu_t, max(end(s) for s in scans[:lo]), side="right"))
    for scan in scans[lo:hi]:
        while ii < m and sim.imu_t[ii] <= end(scan):
            feed_imu(ii)
            ii += 1
        pipe.add_scan(scan.pts, scan.t, intensity=scan.intensity)
        pipe.spin()
    if hi < len(scans):
        return
    while ii < m:
        feed_imu(ii)
        ii += 1
    pipe.spin()
