"""rviz profile generator (a copy of `limovelo_tpu/viz/rviz.py`; PyYAML is
imported when a profile is written).

Where the reference maintains four hand-written rviz YAML files
(`rviz/*.rviz` in the reference), we *generate* them: one source of truth for
the topic names (shared with `runtime/publishers`), per-dataset display
tuning expressed as a small parameter dict.  Emitted configs are standard
rviz 1 `Displays`/`Views` YAML and load with `rviz -d <file>`.

Displays (matching the reference's set, SURVEY.md §2.9/§2.14):
- Grid + TF (map → body frame)
- /limovelo/state     nav_msgs/Odometry      (pose + velocity arrow)
- /limovelo/states    geometry_msgs/PoseArray (recent corrected states)
- /limovelo/pcl       sensor_msgs/PointCloud2 (localization window)
- /limovelo/full_pcl  sensor_msgs/PointCloud2 (map stream)
- /limovelo/planes    geometry_msgs/PoseArray (matched plane normals)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ProfileTuning:
    """Per-dataset display tuning (the only thing that differed between the
    reference's four profiles: point sizes, colors, view scale)."""

    map_point_size: float = 0.03     # meters (Flat Squares)
    window_point_size: float = 0.05
    view_distance: float = 40.0
    map_color_axis: str = "z"        # axis-color the map stream
    decay_time: float = 0.0          # seconds full_pcl points linger


PROFILES: Dict[str, ProfileTuning] = {
    "default": ProfileTuning(),
    "kitti": ProfileTuning(map_point_size=0.05, view_distance=120.0, decay_time=0.0),
    "ouster": ProfileTuning(map_point_size=0.04, window_point_size=0.08, view_distance=60.0),
    "xaloc": ProfileTuning(map_point_size=0.02, window_point_size=0.05, view_distance=25.0),
}


def _pointcloud_display(name: str, topic: str, size: float, axis_color: bool,
                        decay: float) -> dict:
    d = {
        "Class": "rviz/PointCloud2",
        "Name": name,
        "Enabled": True,
        "Topic": topic,
        "Queue Size": 10,
        "Size (m)": size,
        "Style": "Flat Squares",
        "Alpha": 1.0,
        "Decay Time": decay,
        "Position Transformer": "XYZ",
        "Selectable": True,
    }
    if axis_color:
        d.update({"Color Transformer": "AxisColor", "Axis": "Z",
                  "Autocompute Intensity Bounds": True})
    else:
        d.update({"Color Transformer": "FlatColor", "Color": "239; 41; 41"})
    return d


def make_profile(name: str = "default", fixed_frame: str = "map") -> str:
    """Emit an rviz YAML config string for the given dataset profile."""
    try:
        tune = PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown profile {name!r}; have {sorted(PROFILES)}")

    displays = [
        {"Class": "rviz/Grid", "Name": "Grid", "Enabled": True,
         "Cell Size": 10, "Plane": "XY", "Plane Cell Count": 40,
         "Color": "80; 80; 80"},
        {"Class": "rviz/TF", "Name": "TF", "Enabled": True,
         "Show Names": True, "Show Axes": True, "Marker Scale": 3.0},
        {"Class": "rviz/Odometry", "Name": "State", "Enabled": True,
         "Topic": "/limovelo/state", "Keep": 1, "Position Tolerance": 0.05,
         "Angle Tolerance": 0.05,
         "Shape": {"Value": "Arrow", "Shaft Length": 1.0, "Shaft Radius": 0.1,
                   "Head Length": 0.3, "Head Radius": 0.2,
                   "Color": "52; 101; 164"}},
        {"Class": "rviz/PoseArray", "Name": "States", "Enabled": True,
         "Topic": "/limovelo/states", "Shape": "Arrow (Flat)",
         "Arrow Length": 0.3, "Color": "52; 101; 164"},
        _pointcloud_display("Window", "/limovelo/pcl",
                            tune.window_point_size, False, 0.0),
        _pointcloud_display("Map", "/limovelo/full_pcl",
                            tune.map_point_size, tune.map_color_axis == "z",
                            tune.decay_time),
        {"Class": "rviz/PoseArray", "Name": "Planes", "Enabled": False,
         "Topic": "/limovelo/planes", "Shape": "Arrow (Flat)",
         "Arrow Length": 0.5, "Color": "115; 210; 22"},
    ]
    config = {
        "Panels": [
            {"Class": "rviz/Displays", "Name": "Displays",
             "Property Tree Widget": {"Expanded": ["/Global Options1"]}},
            {"Class": "rviz/Views", "Name": "Views"},
        ],
        "Visualization Manager": {
            "Class": "",
            "Global Options": {"Fixed Frame": fixed_frame,
                               "Background Color": "35; 35; 40",
                               "Frame Rate": 30},
            "Displays": displays,
            "Views": {
                "Current": {
                    "Class": "rviz/ThirdPersonFollower",
                    "Name": "Follow",
                    "Target Frame": "body",
                    "Distance": tune.view_distance,
                    "Pitch": 0.9,
                    "Yaw": 3.14,
                },
            },
            "Tools": [{"Class": "rviz/MoveCamera"},
                      {"Class": "rviz/Measure"}],
        },
    }
    import yaml

    return yaml.safe_dump(config, sort_keys=False)
