"""limovelo_tpu_torch — the PyTorch/CUDA port of limovelo_tpu.

The same LiDAR-inertial odometry engine (variable-window iterated error-state
Kalman filter, per-point deskew, voxel hash-grid map with batched KNN),
written in PyTorch for an NVIDIA H100.  The grouped KNN that the JAX package
runs as a Pallas TPU kernel is a hand-written CUDA kernel here
(`ops/cuda/knn.py`, source in `csrc/knn_grouped.cu`), and so are the IMU
chains of the prediction and the deskew (`ops/cuda/imu_chain.py`, source in
`csrc/imu_chain.cu`).

Every entry point takes an explicit `device`; the default is "cuda" and a
missing card raises instead of silently running on the CPU.
"""

import torch as _torch

# SLAM numerics need true f32 products: TF32 keeps ~3 decimal digits, far
# beyond what a centimeter-level estimator tolerates (the counterpart of the
# JAX package's "highest" default matmul precision).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import DEFAULT, KITTI, OUSTER, XALOC, Config, InitializationParams  # noqa: E402
from .device import resolve_device  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Config",
    "InitializationParams",
    "DEFAULT",
    "KITTI",
    "OUSTER",
    "XALOC",
    "resolve_device",
    "__version__",
]
