"""Image-processing ops of the PyTorch AKAZE pipeline.

Each op is a plain function over ``[..., H, W]`` float32 tensors.  The
hand-written CUDA kernels live beside their plain versions in
``sublevel.py`` (K1), ``describe.py`` (K2), ``hamming.py`` (K4),
``detect.py`` (detection's extrema and NMS) and ``pgo.py`` (SLAM's
pose-graph solve); import those modules directly.
"""

from .conv import down_with_smooth, gauss_half_kernel, lowpass, sep_conv2d
from .contrast import percentile_contrast
from .diffusion import conductivity, nld_step
from .scharr import (hessian_determinant, scaled_derivatives,
                     scharr_gradient_xy, scharr_magnitude)

__all__ = [
    "gauss_half_kernel", "lowpass", "sep_conv2d", "down_with_smooth",
    "scharr_gradient_xy", "scharr_magnitude", "scaled_derivatives",
    "hessian_determinant", "percentile_contrast", "conductivity",
    "nld_step",
]
