"""Offline run rendering (matplotlib, Agg, imported when a figure is drawn) —
headless figures for a run; a copy of `limovelo_tpu/viz/plot.py`.

Replaces the live-rviz half of the reference's visualization (§2.14) with a
publication-style figure: top-down (x-y) map cloud + estimated trajectory,
optional ground truth, and a height profile.  Color roles: map context is
muted gray (recessive), estimate is blue, ground truth is orange — a
CVD-safe pair; identity is never color-alone (legend + dash pattern).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

EST_COLOR = "#2563eb"    # blue — estimated trajectory
GT_COLOR = "#ea580c"     # orange — ground truth (dashed)
MAP_COLOR = "#9ca3af"    # muted gray — map context
INK = "#374151"


def render_run(
    out_path: str,
    positions: np.ndarray,
    times: Optional[np.ndarray] = None,
    map_pts: Optional[np.ndarray] = None,
    gt_positions: Optional[np.ndarray] = None,
    title: str = "limovelo_tpu_torch run",
    max_map_points: int = 200_000,
    dpi: int = 150,
):
    """Render a run to PNG/SVG.

    positions: (N,3) estimated trajectory, or None for a map-only figure.
    map_pts: (M,3) map cloud (subsampled for plotting). gt_positions: (K,3)
    optional ground truth.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    positions = None if positions is None else np.asarray(positions)
    if positions is not None and len(positions) == 0:
        positions = None
    has_profile = (
        positions is not None
        and times is not None
        and len(np.asarray(times)) == len(positions)
    )
    if has_profile:
        fig, (ax, axz) = plt.subplots(
            2, 1, figsize=(9, 10), dpi=dpi,
            gridspec_kw={"height_ratios": [4, 1]}, constrained_layout=True,
        )
    else:
        fig, ax = plt.subplots(figsize=(9, 8), dpi=dpi, constrained_layout=True)
        axz = None

    if map_pts is not None and len(map_pts):
        mp = np.asarray(map_pts)
        if len(mp) > max_map_points:
            mp = mp[np.random.default_rng(0).choice(len(mp), max_map_points, False)]
        ax.scatter(mp[:, 0], mp[:, 1], s=0.3, c=MAP_COLOR, alpha=0.35,
                   linewidths=0, label="map", rasterized=True)

    if gt_positions is not None and len(gt_positions):
        gt = np.asarray(gt_positions)
        ax.plot(gt[:, 0], gt[:, 1], color=GT_COLOR, lw=2.0, ls=(0, (4, 2)),
                label="ground truth")
    if positions is not None:
        ax.plot(positions[:, 0], positions[:, 1], color=EST_COLOR, lw=2.0,
                label="estimate")
        ax.plot(positions[0, 0], positions[0, 1], "o", color=EST_COLOR, ms=8,
                mec="white", mew=1.5)

    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("x [m]", color=INK)
    ax.set_ylabel("y [m]", color=INK)
    ax.set_title(title, color=INK, loc="left", fontsize=12)
    ax.grid(True, color="#e5e7eb", lw=0.6)
    for s in ax.spines.values():
        s.set_color("#d1d5db")
    ax.tick_params(colors=INK)
    # legend only when >1 series is plotted
    handles, _ = ax.get_legend_handles_labels()
    if len(handles) > 1:
        ax.legend(loc="best", frameon=True, framealpha=0.9, edgecolor="#d1d5db")

    if axz is not None:
        t = np.asarray(times) - float(np.asarray(times)[0])
        axz.plot(t, positions[:, 2], color=EST_COLOR, lw=1.6)
        axz.set_xlabel("t [s]", color=INK)
        axz.set_ylabel("z [m]", color=INK)
        axz.grid(True, color="#e5e7eb", lw=0.6)
        for s in axz.spines.values():
            s.set_color("#d1d5db")
        axz.tick_params(colors=INK)

    fig.savefig(out_path)
    plt.close(fig)
    return out_path
