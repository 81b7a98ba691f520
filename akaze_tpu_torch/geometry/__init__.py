"""Two-view geometry on tensors: SO(3)/SE(3), epipolar geometry, RANSAC.

Port of ``akaze_tpu/geometry``.  Everything is batched and statically
shaped, plain PyTorch on the tensors' device.  The homography module
(``homography_from_points``, ``ransac_homography``, ``pnp_dlt``) is not
ported yet: the SLAM path does not use it.
"""

from .se3 import (so3_exp, so3_log, se3_exp, se3_log, se3_inverse,
                  se3_compose, se3_apply, se3_identity)
from .epipolar import (essential_from_eight, decompose_essential,
                       triangulate, sampson_error, recover_pose)
from .ransac import ransac_essential, RansacResult

__all__ = [
    "so3_exp", "so3_log", "se3_exp", "se3_log", "se3_inverse",
    "se3_compose", "se3_apply", "se3_identity",
    "essential_from_eight", "decompose_essential", "triangulate",
    "sampson_error", "recover_pose", "ransac_essential", "RansacResult",
]
