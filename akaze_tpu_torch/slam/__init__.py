"""SLAM back-end: visual odometry, pose-graph optimisation, bundle
adjustment and the full system with its checkpoints.

Port of ``akaze_tpu/slam``.  The solvers are plain PyTorch on the device
(fixed-length loops whose accept tests stay on the device); the kernels of
the path are the front-end's K1, K2 and K4.
"""

from .posegraph import PoseGraph, optimize_pose_graph
from .system import SlamSystem, SlamConfig
from .odometry import VisualOdometry, Intrinsics
from .ba import BAProblem, bundle_adjust, ba_residuals

__all__ = ["PoseGraph", "optimize_pose_graph", "BAProblem", "bundle_adjust",
           "ba_residuals", "SlamSystem", "SlamConfig", "VisualOdometry",
           "Intrinsics"]
