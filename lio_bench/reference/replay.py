"""Replay the messages the program received through the plain reference
(`lio/`, a frozen copy of the port's plain path) and return its state after
every window it processed.

The reference makes its own configuration (from the same files), its own
ingest, its own windows, map and telemetry from the messages.  What it takes
from the program is the filter state the program held before each window
(`follow`): the estimator is chaotic on these streams (a rounding-level
difference, such as the order of the card's atomic additions, grows into
centimetres over a lap), so each window is checked as one step from the
program's own state, not as a whole trajectory.  Before window k the
reference's state, covariance and deskew anchor are set to the program's
after window k-1; the map stays the reference's own (built by its own
inserts from those steps).  Window 0 starts from the reference's own
initial state.

`kind="tf32"` is the comparison's control: the same replay with TensorFloat-32
matrix products, the precision one step below the configuration's float32.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch

from ..cells import build_config
from ..compare import collect
from .lio import config as ref_config
from .lio.geometry.state import NavState
from .lio.ingest import decode_velodyne
from .lio.runtime.pipeline import LioPipeline


@contextmanager
def precision(kind: str):
    if kind not in ("float32", "tf32"):
        raise ValueError(f"precision {kind!r}: float32 or tf32")
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = kind == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _follow(pipe: LioPipeline, follow: Optional[list]) -> None:
    """Before its k-th window (k ≥ 1) `pipe` takes the state, covariance
    and anchor that `follow[k-1]` (t2, state, P, anchor, anchor_t) holds."""
    if not follow:
        return
    step = pipe.step_window
    k = [0]

    def step_window(t1, t2):
        i = k[0]
        k[0] += 1
        if 0 < i <= len(follow):
            _, x, P, anchor, anchor_t = follow[i - 1]
            pipe.x = NavState(*(f.detach().clone() for f in x))
            pipe.P = P.detach().clone()
            pipe.anchor = NavState(*(f.detach().clone() for f in anchor))
            pipe.anchor_t_dev = anchor_t.detach().clone()
        return step(t1, t2)

    pipe.step_window = step_window


def feed(pipe, cfg, stream, lo: int, hi: int, spin_every_imu: bool, windows=None) -> None:
    """Messages [lo, hi) into `pipe`, each scan and (with `spin_every_imu`)
    each IMU sample followed by a spin; (t2, state, P, anchor, anchor_t) of
    every processed window appended to `windows`."""
    for m in range(lo, hi):
        kind, msg = stream.message(m)
        if kind == "imu":
            pipe.add_imu(*msg)
            if not spin_every_imu:
                continue
        else:
            xyz, rel, stamp, inten = msg
            pts, t, i = decode_velodyne(cfg, xyz, stamp, rel, inten)
            pipe.add_scan(pts, t, intensity=i)
        while pipe.spin_once():
            if windows is not None:
                windows.append((pipe.t2, pipe.x, pipe.P, pipe.anchor, pipe.anchor_t_dev))


def replay(cell, stream, n_messages: int, device, kind: str = "float32",
           follow: Optional[List] = None):
    """(outputs, windows) of the reference over messages [0, n_messages) of
    `stream`; `follow`: the program's windows to follow."""
    spin_every_imu = bool(cell.config["feed"]["spin_every_imu"])
    cfg = build_config(ref_config, cell.config, cell.mix)
    with precision(kind), torch.no_grad():
        pipe = LioPipeline(cfg, device=device)
        _follow(pipe, follow)
        windows: list = []
        feed(pipe, cfg, stream, 0, n_messages, spin_every_imu, windows)
        return collect(windows, pipe.result.records), windows
