"""Configuration system.

Frozen dataclass mirror of the reference's rosparam loader
(`src/main.cpp:135-176`, struct at
`include/Headers/Common.hpp:56-107`), with the same parameter names and
defaults, plus sizing knobs (hash-map capacity, padding buckets) the
reference does not need.  Field for field the same as `limovelo_tpu.config`,
so a configuration carries across packages unchanged (see `interop.py`).
Unlike the reference — which mutates the global
`Params Config` at runtime when per-point timestamps are missing
(`Accumulator.cpp:183-185`) — this config is immutable; the missing-timestamp
fallback is explicit state in the runtime (see runtime/accumulator.py).

Per-dataset YAML profiles (config/*.yaml in the reference) are supported via
``Config.from_yaml``; the built-in dataset profiles (KITTI / XALOC / OUSTER /
DEFAULT) ship as Python constants in this module.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np

#: the JAX package's `knn_backend` names → the port's
_JAX_BACKENDS = {"xla": "dense", "pallas": "grouped"}


def _ident9() -> Tuple[float, ...]:
    return (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class StaticConfig(NamedTuple):
    """The structural subset of the config: it changes shapes or control
    flow (which code runs), so it is plain Python values."""

    MAX_NUM_ITERS: int
    NUM_MATCH_POINTS: int
    estimate_extrinsics: bool
    mapping_online: bool
    knn_rings: int
    knn_max_buckets: object   # int | None — tiered-KNN bucket budget
    knn_backend: str = "dense"  # "dense" | "grouped" (1-ring only)
    match_mode: str = "rematch"  # "auto" | "freeze" | "rematch"
    # eigendecompose HᵀH for gating/diagnostics?  False when gating is off
    # and eigenvalue printing is off
    compute_degeneracy: bool = True
    # dtype of the 23×23 prior/solve chain inside the iterated update
    solve_dtype: str = "f64"


def _f32(v) -> float:
    """Round a Python float to the nearest float32 (the thresholds enter
    float32 arithmetic, as in the reference package)."""
    return float(np.float32(v))


class DynParams(NamedTuple):
    """Numerical parameters as Python scalars (rounded to float32)."""

    MAX_DIST_PLANE: float
    PLANES_THRESHOLD: float
    plane_planarity: float
    plane_linearity: float
    QUERY_THRESHOLD: float
    huber_delta: float
    LiDAR_noise: float
    degeneracy_threshold: float
    LIMITS: float
    downsample_prec: float
    MAX_POINTS2MATCH: int
    match_refresh_m: float = 0.05

    @classmethod
    def from_config(cls, c: "Config") -> "DynParams":
        return cls(
            MAX_DIST_PLANE=_f32(c.MAX_DIST_PLANE),
            PLANES_THRESHOLD=_f32(c.PLANES_THRESHOLD),
            plane_planarity=_f32(c.plane_planarity),
            plane_linearity=_f32(c.plane_linearity),
            QUERY_THRESHOLD=_f32(c.QUERY_THRESHOLD),
            huber_delta=_f32(c.huber_delta),
            match_refresh_m=_f32(c.match_refresh_m),
            LiDAR_noise=_f32(c.LiDAR_noise),
            degeneracy_threshold=_f32(c.degeneracy_threshold),
            LIMITS=_f32(c.LIMITS),
            downsample_prec=_f32(c.downsample_prec),
            MAX_POINTS2MATCH=int(c.MAX_POINTS2MATCH),
        )



@dataclass(frozen=True)
class InitializationParams:
    """Warm-up delta schedule (`config/params.yaml:59-66`).

    ``deltas`` must have exactly one more entry than ``times``
    (`Accumulator.cpp:124-127`).  Entry k applies while
    ``t - initial_time < times[k]``; the last delta applies afterwards.
    """

    times: Tuple[float, ...] = ()
    deltas: Tuple[float, ...] = (0.1,)

    def delta_at(self, t_since_init: float) -> float:
        # interpret_initialization, Accumulator.cpp:165-176
        assert len(self.times) + 1 == len(self.deltas), (
            "There has to be exactly one more delta value than time delimiters"
        )
        for k, tk in enumerate(self.times):
            if t_since_init < tk:
                return self.deltas[k]
        return self.deltas[-1]


@dataclass(frozen=True)
class Config:
    # --- Online/offline (main.cpp:137-138) ---
    mapping_online: bool = True
    real_time: bool = True
    # Three-way mapping mode (beyond the reference's bool):
    #   "online"  — insert every accepted window (mapping_online=true)
    #   "offline" — re-deskew + insert every full rotation (main.cpp:107-117)
    #   "none"    — NEVER insert: the map stays frozen (HD-map
    #               prelocalization, the reference's unfinished hdmaps goal,
    #               README.md:64-68)
    # None (default) derives from `mapping_online` for reference parity.
    mapping: object = None           # str | None

    # --- Extrinsics (main.cpp:139-140, 172-174) ---
    estimate_extrinsics: bool = False
    print_extrinsics: bool = False
    initial_gravity: Tuple[float, float, float] = (0.0, 0.0, -9.807)
    I_Translation_L: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    I_Rotation_L: Tuple[float, ...] = field(default_factory=_ident9)

    # --- Downsampling (main.cpp:141-142) ---
    downsample_rate: int = 4
    downsample_prec: float = 0.2

    # --- Publishing (main.cpp:143) ---
    high_quality_publish: bool = False

    # --- Estimator budget (main.cpp:144-149) ---
    MAX_NUM_ITERS: int = 3
    LIMITS: float = 0.001           # reference: vector(23, 0.001)
    NUM_MATCH_POINTS: int = 5
    MAX_POINTS2MATCH: int = 10
    MAX_DIST_PLANE: float = 2.0
    PLANES_THRESHOLD: float = 0.1
    PLANES_CHOOSE_CONSTANT: float = 9.0   # declared, unused in reference too
    # beyond-reference junction gate: reject neighbor sets whose scatter has
    # λ_min > plane_planarity·λ_mid (corner/edge pseudo-planes that pass the
    # absolute PLANES_THRESHOLD gate; see ops/planes.py).  1.0 disables.
    plane_planarity: float = 0.12
    # beyond-reference collinearity gate: reject neighbor sets whose scatter
    # has λ_mid < plane_linearity·λ_max (scan-line stripes whose fitted
    # normal is rotationally ambiguous; see ops/planes.py).  0 disables.
    plane_linearity: float = 0.04
    # beyond-reference query gate: reject matches whose own point-to-plane
    # distance exceeds this (meters).  Neighbor sets spanning TWO surfaces
    # (pillar face + wall behind) can form perfectly planar DIAGONAL fits
    # that pass both residual and planarity gates, yet sit 50-100 mm from
    # the query's true surface — the query residual is the discriminator
    # (same idea as FAST-LIO2's s>0.9 match quality gate, but absolute).
    # 0 disables (reference behavior: query residual enters the solve raw).
    # NOTE a hard gate can reject the very matches that would correct a
    # drifting estimate (measured: locks in a velocity deficit on the 20 m/s
    # straight); prefer `huber_delta` unless the map is trusted (HD-map
    # prelocalization).
    QUERY_THRESHOLD: float = 0.0
    # robust (Huber) IRLS weight on the point-to-plane residuals: matches
    # with |r| > huber_delta get weight huber_delta/|r| inside the GN normal
    # equations.  Downweights junction pseudo-plane artifacts (50-100 mm
    # residuals vs the ~1-30 mm inlier band) without going blind to large
    # genuine innovations the way a hard gate does.  0 disables (reference
    # behavior: pure least squares).
    huber_delta: float = 0.0

    # --- LiDAR (main.cpp:151-154) ---
    LiDAR_type: str = "unknown"      # velodyne | hesai | ouster | custom
    LiDAR_noise: float = 0.001       # measurement variance of point-plane dist
    min_dist: float = 3.0
    full_rotation_time: float = 0.1
    offset_beginning: bool = False
    stamp_beginning: bool = False

    # --- IMU (main.cpp:155) ---
    imu_rate: float = 400.0

    # --- Degeneracy gating (main.cpp:156-157; fork extension of IKFoM) ---
    degeneracy_threshold: float = 5.0
    print_degeneracy_values: bool = False

    # --- Delays (main.cpp:159-160) ---
    empty_lidar_time: float = 20.0
    real_time_delay: float = 1.0

    # --- Process noise covariances (main.cpp:161-164) ---
    covariance_gyroscope: float = 1e-4
    covariance_acceleration: float = 1e-2
    covariance_bias_gyroscope: float = 1e-5
    covariance_bias_acceleration: float = 1e-4

    # --- Initial extrinsic covariance (Localizator.cpp:148-156 uses 1e-5:
    #     a refinement prior that assumes the config extrinsics are nearly
    #     right).  Raise for online calibration from a coarse guess.
    #
    #     `initial_cov_extrinsic_rot` may be a per-axis 3-tuple in the
    #     LiDAR-frame tangent (roll, pitch, yaw).  With a self-built map,
    #     extrinsic YAW is gauge-degenerate with global yaw whenever the
    #     body's angular motion is mostly about gravity (the pair only
    #     enters through the product R·R_LI, and a yaw offset commutes with
    #     yaw-only motion), so a wide isotropic prior lets the pair random-
    #     walk together while roll/pitch — pinned through gravity — are the
    #     directions online calibration can actually observe.  The
    #     recommended online-calibration setting is therefore anisotropic:
    #     wide roll/pitch, near-frozen yaw (trust the CAD yaw), e.g.
    #     (1e-4, 1e-4, 1e-8).  See tests/test_racing.py. ---
    initial_cov_extrinsic_rot: object = 1e-5   # float | (roll, pitch, yaw)
    initial_cov_extrinsic_trans: float = 1e-5

    # --- Velocity multipliers (main.cpp:165-167; unused in ref pipeline) ---
    wx_MULTIPLIER: float = 1.0
    wy_MULTIPLIER: float = 1.0
    wz_MULTIPLIER: float = 1.0

    # --- Topics (main.cpp:168-169); used by the rosbag reader ---
    points_topic: str = "/velodyne_points"
    imus_topic: str = "/vectornav/IMU"

    # --- Warm-up schedule (main.cpp:170-171) ---
    Initialization: InitializationParams = field(default_factory=InitializationParams)

    # ------------------------------------------------------------------
    # Device-side knobs (no reference analog)
    # ------------------------------------------------------------------
    # map lifecycle: forget voxel buckets farther than `map_prune_radius`
    # meters from the current pose, checked every `map_prune_every` seconds
    # of data time.  0 = never prune (reference behavior: the ikd-Tree grows
    # without bound, SURVEY.md §5 long-context row).
    map_prune_radius: float = 0.0
    map_prune_every: float = 1.0
    map_voxel_size: float = 0.2      # ikd-Tree downsample resolution (Mapper.cpp:65)
    map_coarse_factor: int = 4       # coarse bucket edge, in fine voxels
    map_table_size: int = 1 << 17    # hash buckets (coarse voxels)
    map_probe_length: int = 8        # max linear-probe distance
    # KNN search envelope.  None (default) derives the rings from the plane
    # gate: ceil(MAX_DIST_PLANE / coarse_size), so the matcher covers the full
    # MAX_DIST_PLANE radius the reference's exact whole-map Nearest_Search
    # reaches (Mapper.cpp:86 + Plane.cpp:40-43).  Set 1 explicitly for the
    # cheap 27-bucket neighborhood (exact to 0.8 m) on dense maps.
    knn_rings: object = None         # int | None
    # With rings ≥ 2 the slot gather is tiered: only the `knn_max_buckets`
    # nearest occupied buckets (AABB lower bound) are fetched per query.
    # Recall vs an exact oracle is regression-tested (test_knn_fidelity.py).
    knn_max_buckets: object = 32     # int | None
    # KNN backend for the match: "dense" (per-query gather + top-k,
    # mapping.hashgrid.knn) or "grouped" (the grouped CUDA kernel,
    # ops/cuda/knn.py).  The grouped kernel covers the 1-ring envelope only;
    # the backend falls back to "dense" when the derived rings > 1.
    knn_backend: str = "dense"
    # GN match cadence: "rematch" re-runs the KNN search every Gauss-Newton
    # iteration (the reference's IKFoM h_share_model cadence — 3 full map
    # gathers per step).  "freeze" searches ONCE at the predicted state and
    # re-evaluates only residuals/gates against the frozen neighbor sets in
    # later iterations (the plane geometry depends only on the neighbors).
    # "auto" (default) freezes but RE-searches whenever the iterate's
    # placement has moved more than `match_refresh_m` since the last search:
    # converged steady-state steps pay ONE map gather (~3× less match HBM
    # traffic), while large-correction steps (cold start, online extrinsic
    # calibration from a coarse guess, degraded prediction) automatically
    # restore the reference's full rematch fidelity.
    match_mode: str = "auto"         # "auto" | "freeze" | "rematch"
    # "auto" re-search trigger: upper bound (m) on how far any window point's
    # global placement may drift from where its neighbors were last searched
    # before the KNN re-runs.  It must sit below the per-window innovation
    # scale, not the map-voxel scale (the value tuned in the JAX package).
    match_refresh_m: float = 0.05
    point_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192, 16384)
    ds_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    imu_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)
    dtype: str = "float32"
    # precision of the 23×23 update solve chain ("f64" | "f32") — see
    # StaticConfig.solve_dtype
    solve_dtype: str = "f64"

    # ------------------------------------------------------------------
    @property
    def gravity_vec(self) -> Tuple[float, float, float]:
        """The gravity vector used in dynamics: v̇ = R(a−ba) + g.

        The reference stores config gravity and subtracts it
        (`State.cpp:104-105`); IKFoM stores the negated config vector and adds
        (`Localizator.cpp:139`).  We follow the latter everywhere.
        """
        gx, gy, gz = self.initial_gravity
        return (-gx, -gy, -gz)

    @property
    def mapping_mode(self) -> str:
        """Resolved mapping mode: explicit `mapping` wins, else derived from
        the reference-parity `mapping_online` bool."""
        if self.mapping is not None:
            assert self.mapping in ("online", "offline", "none"), self.mapping
            return self.mapping
        return "online" if self.mapping_online else "offline"

    @property
    def map_coarse_size(self) -> float:
        return self.map_voxel_size * self.map_coarse_factor

    @property
    def map_slots(self) -> int:
        return self.map_coarse_factor ** 3

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def effective_knn_rings(self) -> int:
        if self.knn_rings is not None:
            return int(self.knn_rings)
        return max(1, math.ceil(self.MAX_DIST_PLANE / self.map_coarse_size - 1e-6))

    def static(self) -> StaticConfig:
        rings = self.effective_knn_rings
        return StaticConfig(
            MAX_NUM_ITERS=self.MAX_NUM_ITERS,
            NUM_MATCH_POINTS=self.NUM_MATCH_POINTS,
            estimate_extrinsics=self.estimate_extrinsics,
            mapping_online=(self.mapping_mode == "online"),
            knn_rings=rings,
            # tiering only matters beyond the 27-bucket neighborhood
            knn_max_buckets=(
                int(self.knn_max_buckets)
                if (self.knn_max_buckets is not None and rings > 1)
                else None
            ),
            knn_backend=(self.knn_backend if rings == 1 else "dense"),
            match_mode=self.match_mode,
            # the 12×12 eigh costs an iterative device loop per GN iteration;
            # compile it out when nothing consumes it (threshold 0 = gating
            # off, reference semantics — and eigenvalue printing off)
            compute_degeneracy=(
                self.degeneracy_threshold != 0.0 or self.print_degeneracy_values
            ),
            solve_dtype=self.solve_dtype,
        )

    def dynamic(self) -> DynParams:
        return DynParams.from_config(self)

    def bucket_for(self, n: int, buckets: Tuple[int, ...]) -> int:
        """Smallest padding bucket that fits n items (bounds recompiles).
        Beyond the configured list, grow by powers of two — dropping data
        (IMU samples especially) is never acceptable."""
        for b in buckets:
            if n <= b:
                return b
        b = buckets[-1]
        while b < n:
            b *= 2
        return b

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d)
        # accept reference YAML aliases
        alias = {
            "covariance_gyroscope": "covariance_gyroscope",
            "ds_rate": "downsample_rate",
        }
        for src, dst in alias.items():
            if src in d and dst not in d:
                d[dst] = d.pop(src)
        # the JAX package's KNN backend names (its YAML files carry them)
        if d.get("knn_backend") in _JAX_BACKENDS:
            d["knn_backend"] = _JAX_BACKENDS[d["knn_backend"]]
        init = d.pop("Initialization", None)
        kw = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k not in fields:
                continue
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        if init is not None:
            kw["Initialization"] = InitializationParams(
                times=tuple(init.get("times", ())),
                deltas=tuple(init.get("deltas", (kw.get("full_rotation_time", 0.1),))),
            )
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml  # lazy; pyyaml is in the image

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


#: Profile equivalent to the reference's config/kitti.yaml
KITTI = Config(
    mapping_online=True,
    real_time=False,
    initial_gravity=(0.0, 0.0, +9.807),
    I_Translation_L=(-8.086759e-01, 3.195559e-01, -7.997231e-01),
    I_Rotation_L=(
        9.999976e-01, 7.553071e-04, -2.035826e-03,
        -7.854027e-04, 9.998898e-01, -1.482298e-02,
        2.024406e-03, 1.482454e-02, 9.998881e-01,
    ),
    empty_lidar_time=1.0,
    real_time_delay=0.5,
    LiDAR_type="velodyne",
    LiDAR_noise=0.001,
    full_rotation_time=0.10,
    min_dist=4.0,
    downsample_rate=4,
    imu_rate=1000.0,
    covariance_gyroscope=1e-1,
    covariance_acceleration=1e-1,
    covariance_bias_gyroscope=1e-4,
    covariance_bias_acceleration=1e-4,
    MAX_DIST_PLANE=2.23,
    PLANES_THRESHOLD=1e-1,
    degeneracy_threshold=400.0,
    Initialization=InitializationParams(times=(), deltas=(0.1,)),
)

#: Profile equivalent to the reference's config/xaloc.yaml (Formula Student
#: car; its Velodyne stamps points as offsets from the rotation start)
XALOC = Config(
    mapping_online=True,
    real_time=True,
    high_quality_publish=True,
    estimate_extrinsics=True,
    initial_gravity=(0.0, 0.0, -9.807),
    I_Translation_L=(1.25, 0.0, 0.0),
    I_Rotation_L=(1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, -1.0),
    empty_lidar_time=0.1,
    real_time_delay=0.1,
    LiDAR_type="velodyne",
    stamp_beginning=False,
    offset_beginning=True,
    LiDAR_noise=0.001,
    full_rotation_time=0.1,
    min_dist=4.0,
    downsample_rate=4,
    downsample_prec=0.5,
    imu_rate=400.0,
    covariance_gyroscope=6.01e-4,
    covariance_acceleration=1.53e-2,
    covariance_bias_gyroscope=1.54e-5,
    covariance_bias_acceleration=3.38e-4,
    MAX_DIST_PLANE=2.0,
    PLANES_THRESHOLD=5e-2,
    degeneracy_threshold=5.0,
    points_topic="/velodyne_points",
    imus_topic="/vectornav/IMU",
    Initialization=InitializationParams(
        times=(0.5, 1.0, 1.25), deltas=(0.1, 0.05, 0.02)
    ),
)

#: Profile equivalent to the reference's config/ouster.yaml (OS1-16 sample)
OUSTER = Config(
    mapping_online=True,
    real_time=False,
    high_quality_publish=False,
    initial_gravity=(0.0, 0.0, +9.807),
    I_Translation_L=(0.006253, -0.011775, 0.028535),
    I_Rotation_L=(-1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0),
    empty_lidar_time=0.1,
    real_time_delay=0.1,
    LiDAR_type="ouster",
    stamp_beginning=False,
    offset_beginning=True,
    LiDAR_noise=0.001,
    full_rotation_time=0.1,
    min_dist=4.0,
    downsample_rate=4,
    downsample_prec=0.5,
    imu_rate=100.0,
    covariance_gyroscope=1e-1,
    covariance_acceleration=1e-1,
    covariance_bias_gyroscope=1e-4,
    covariance_bias_acceleration=1e-4,
    MAX_DIST_PLANE=2.0,
    PLANES_THRESHOLD=1e-1,
    degeneracy_threshold=5.0,
    points_topic="/os1_cloud_node/points",
    imus_topic="/os1_cloud_node/imu",
    Initialization=InitializationParams(times=(), deltas=(0.1,)),
)

#: Profile equivalent to the reference's config/params.yaml defaults
DEFAULT = Config(
    mapping_online=True,
    real_time=False,
    high_quality_publish=True,
    empty_lidar_time=0.1,
    real_time_delay=0.1,
    LiDAR_type="velodyne",
    min_dist=4.0,
    downsample_prec=0.5,
    imu_rate=200.0,
    PLANES_THRESHOLD=5e-2,
    Initialization=InitializationParams(times=(0.5, 1.0), deltas=(0.1, 0.05, 0.02)),
)

#: name → profile lookup for the CLI (`--config kitti|xaloc|ouster|default`);
#: any other value is read as a YAML path (`Config.from_yaml`).  A caller may
#: add entries (chip_smoke.py does, to hand the CLI a configuration on a
#: machine without PyYAML).
PROFILES = {
    "kitti": KITTI,
    "xaloc": XALOC,
    "ouster": OUSTER,
    "default": DEFAULT,
}
