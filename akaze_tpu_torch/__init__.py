"""PyTorch + CUDA port of the AKAZE front-end of ``akaze_tpu``.

FED nonlinear scale space, Hessian-determinant keypoints with sub-pixel
refinement, MLDB binary descriptors and brute-force Hamming matching, float
path.  Three kernels are written by hand for Hopper (``csrc/``): the fused
scale-space sublevel (K1, ops/sublevel.py), orientation + descriptor cell
sums (K2, ops/describe.py) and the running-top-2 Hamming matcher (K4,
ops/hamming.py).  They build with nvcc at first use; on CPU tensors each
runs its plain PyTorch version.

This package imports torch and numpy, never jax and never ``akaze_tpu``.
"""

from .config import AkazeConfig, Diffusivity, config_from
from .match import Matches, hamming_distance_matrix, match
from .pipeline import (Akaze, Features, detect_and_compute,
                       detect_and_compute_batch, detect_and_compute_pair,
                       features_to_numpy)
from .plan import PipelinePlan, build_plan

__all__ = [
    "AkazeConfig", "Diffusivity", "config_from", "Akaze", "Features",
    "detect_and_compute", "detect_and_compute_batch",
    "detect_and_compute_pair", "features_to_numpy", "PipelinePlan",
    "build_plan", "Matches", "match", "hamming_distance_matrix",
]
