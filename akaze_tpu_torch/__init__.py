"""PyTorch + CUDA port of ``akaze_tpu``: AKAZE front-end and SLAM back end.

FED nonlinear scale space, Hessian-determinant keypoints with sub-pixel
refinement, MLDB binary descriptors and brute-force Hamming matching, on
the float path and on the 16.16 fixed-point path (``Akaze(...,
fixed=True)``).  Three kernels are written by hand for Hopper
(``csrc/``): the fused scale-space sublevel (K1, ops/sublevel.py),
orientation + descriptor cell sums (K2, ops/describe.py; it also serves
the JAX package's private-window kernel K3) and the running-top-2 Hamming
matcher (K4, ops/hamming.py); K1 and K2 have a float and a fixed flavour.
They build with nvcc at first use; on CPU tensors each runs its plain
PyTorch version.

``geometry`` (SE(3), two-view geometry, RANSAC) and ``slam`` (visual
odometry, pose-graph optimisation, bundle adjustment, ``SlamSystem`` and
its checkpoints) port the JAX package's back end in plain PyTorch on the
same device; ``io.dataset`` holds the sequence utilities.  ``parallel``
ports the multi-device tiers (a mesh of devices, several shards allowed on
one; the row-sharded spatial tier, the sharded matcher, data-parallel
pairs, sharded PGO and BA, the multi-process runtime), reached through
``Akaze(mesh=...)``, ``slam.SlamSystem(mesh=...)`` and the CLI's
``--spatial N``.

``programs`` is the counterpart of ``jax.jit``: ``Akaze``'s calls, the
SLAM path's two-view solve, loop-candidate scoring, PGO and local BA, and
the essential and homography RANSAC run as compiled programs, one
captured CUDA graph per static signature on the card
(``programs.eager()`` runs them eagerly, ``programs.clear()`` drops the
graphs; the CPU never captures).  The RANSAC draws run eagerly between
them, and ``geometry/linalg.py``'s sync-free solvers stand in for
``torch.linalg.eigh`` and ``svd`` there.

This package imports torch and numpy, never jax and never ``akaze_tpu``.
"""

from .config import AkazeConfig, Diffusivity, config_from
from .match import Matches, hamming_distance_matrix, match
from .pipeline import (Akaze, Features, detect_and_compute,
                       detect_and_compute_batch, detect_and_compute_pair,
                       features_from_numpy, features_to_numpy)
from .plan import PipelinePlan, build_plan
from . import programs

__version__ = "0.2.0"     # the JAX package's version, whose API this ports

__all__ = [
    "AkazeConfig", "Diffusivity", "config_from", "Akaze", "Features",
    "detect_and_compute", "detect_and_compute_batch",
    "detect_and_compute_pair", "features_from_numpy", "features_to_numpy",
    "PipelinePlan",
    "build_plan", "Matches", "match", "hamming_distance_matrix", "programs",
    "__version__",
]
