"""Nonlinear (FED) scale-space construction (PyTorch).

Port of ``akaze_tpu/scale_space.py``: the state machine of
``Akazer::detect`` (akaze.cpp:300-439) and, for an int32 image, of the
16.16 fixed-point ``Akazer::fastDetect`` (akaze.cpp:506-743).  Each
octave runs through kernel K1 (``ops/sublevel.octave``) on CUDA tensors:
one launch of the octave-resident kernel for a small octave
(``routes_resident``), else one tiled launch per sublevel.  K1 writes
every plane into the octave's stack; nothing is copied after it.  CPU
tensors take K1's plain version.

Per sublevel four planes are kept, mirroring the reference's octave
scratch layout (akaze.cpp:315-320):

  L    diffused image (descriptor intensity samples)
  det  Hessian determinant response (detection)
  lx   first derivative Lx at the sublevel's sigma step
  ly   first derivative Ly

Derivatives are taken on the sigma=1-smoothed predecessor image, as the
reference does (gDerivate src = the ``smooth`` plane; akaze.cpp:344,423).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from .ops.contrast import percentile_contrast, percentile_contrast_fixed
from .ops.conv import (down_with_smooth, down_with_smooth_fixed, lowpass,
                       lowpass_fixed, radius_for_ksize)
from .ops.diffusion import inverse_square
from .ops.scharr import scharr_magnitude, scharr_magnitude_fixed
from .ops.sublevel import octave
from .plan import PipelinePlan


class OctaveData(NamedTuple):
    """Stacked per-sublevel planes of one octave: each [S, H, W], or
    [B, S, H, W] for a batch."""
    L: torch.Tensor
    det: torch.Tensor
    lx: torch.Tensor
    ly: torch.Tensor


def base_smooth(config) -> Tuple[float, int]:
    """(variance, radius) of the first octave's base smooth, whose result
    is the first sublevel's L (sigma = soffset, akaze.cpp:325-332)."""
    ksz = 2 * math.ceil((config.soffset - 0.8) / 0.3) + 3
    return config.soffset * config.soffset, radius_for_ksize(ksz)


def build_scale_space(image: torch.Tensor, plan: PipelinePlan
                      ) -> Tuple[List[OctaveData], torch.Tensor]:
    """Build the nonlinear scale space.

    Args:
      image: [H, W] or [B, H, W]; float32 in [0, 1] for the float path,
        int32 raw 0..255 for the 16.16 fixed-point path (the reference
        never normalises the fast path's input, main.cpp:257-258).  A batch
        builds all B pyramids with the same K1 launches.
      plan: static plan from ``build_plan``.

    Returns:
      (octaves, kcontrast): per-octave stacked planes of the image's type
      ([S, H, W], or [B, S, H, W] for a batch) and the contrast factor after
      all octave decays (scalar, or [B]; int32 on the fixed path).
    """
    cfg = plan.config
    fixed = image.dtype == torch.int32
    if not fixed and image.dtype != torch.float32:
        raise TypeError(f"image must be float32 or int32, got {image.dtype}")
    batched = image.dim() == 3
    x = (image if batched else image[None]).contiguous()

    octaves: List[OctaveData] = []
    kcontrast = None
    for oi, oct_plan in enumerate(plan.octaves):
        smooth = base = None
        if oi == 0:
            # first sublevel (akaze.cpp:325-353): contrast percentile on a
            # sigma=1 smooth, then L = the base smooth with sigma = soffset
            # (no diffusion)
            if fixed:
                mag = scharr_magnitude_fixed(lowpass_fixed(x, 1.0, 5))
                kcontrast = percentile_contrast_fixed(mag, cfg.per)
            else:
                mag = scharr_magnitude(lowpass(x, 1.0, 5))
                kcontrast = percentile_contrast(mag, cfg.per)
            base = base_smooth(cfg)
            src = x
        else:
            # new octave (akaze.cpp:371-391): decay kcontrast, decimate the
            # last L with the fused smooth, diffuse the full tau cycle; the
            # next sublevels (akaze.cpp:393-420) smooth the previous L
            last = octaves[-1].L[:, -1]
            if fixed:
                kcontrast = (kcontrast.to(torch.float32) * 0.75
                             + 0.5).to(torch.int32)
                src, smooth = down_with_smooth_fixed(last)
            else:
                kcontrast = kcontrast * 0.75
                src, smooth = down_with_smooth(last)
        octaves.append(OctaveData(*octave(
            src, inverse_square(kcontrast), oct_plan, smooth=smooth,
            base=base, diffusivity=cfg.diffusivity, fixed=fixed)))
    if not batched:
        octaves = [OctaveData(*(p[0] for p in o)) for o in octaves]
    return octaves, (kcontrast if batched else kcontrast[0])
