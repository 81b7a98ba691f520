"""A frozen plain copy of the port's SLAM system: two-view solve, scale
propagation and keyframes, loop closure, pose-graph optimisation and
bundle adjustment, the SLAM cell's reference, which replays a whole pass
of frames on its own.  The modules are copies of ``akaze_tpu_torch``'s
geometry, odometry, system and solvers with the compiled program wrappers
taken away; nothing here imports the program.
"""

from .system import Intrinsics, SlamConfig, System

__all__ = ["Intrinsics", "SlamConfig", "System"]
