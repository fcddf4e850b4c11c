"""Visualization layer (a copy of `limovelo_tpu/viz/`, which the port must
not import) — the analog of the reference's rviz profiles
(`rviz/{limovelo,kitti,ouster,xaloc}.rviz` in the reference, SURVEY.md §2.14).

The reference ships four hand-tuned rviz configs with displays for the state
odometry, window cloud, map stream, and plane normals (topics at
`rviz/limovelo.rviz:70,96,124,152,171`).  A headless engine needs two things
instead:

1. `rviz.make_profile(...)` — *generates* an rviz config wired to the ROS
   bridge topics (`runtime/publishers.make_ros1_bridge`), one per dataset
   profile, so reference users keep their rviz workflow.
2. `plot.render_run(...)` / `export.write_ply(...)` — fully offline
   rendering: top-down trajectory + map figures (PNG/SVG) and PLY point
   clouds any external viewer (CloudCompare, meshlab, Open3D) can open.

matplotlib and PyYAML are imported only when a figure or an rviz profile is
written: importing this package needs neither.
"""

from .export import trajectory_to_ply, write_ply
from .plot import render_run
from .rviz import PROFILES, make_profile

__all__ = [
    "PROFILES",
    "make_profile",
    "render_run",
    "write_ply",
    "trajectory_to_ply",
]
