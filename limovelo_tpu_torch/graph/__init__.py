from .keyframes import KeyframeSelector, KeyframeStore
from .loop_closure import detect_loop_candidates, register_scan_to_map
from .posegraph import PoseGraph, optimize_pose_graph, optimize_pose_graph_sharded

__all__ = [
    "KeyframeStore",
    "KeyframeSelector",
    "PoseGraph",
    "optimize_pose_graph",
    "optimize_pose_graph_sharded",
    "detect_loop_candidates",
    "register_scan_to_map",
]
