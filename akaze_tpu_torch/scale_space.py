"""Nonlinear (FED) scale-space construction (PyTorch).

Port of ``akaze_tpu/scale_space.py``: the state machine of
``Akazer::detect`` (akaze.cpp:300-439) and, for an int32 image, of the
16.16 fixed-point ``Akazer::fastDetect`` (akaze.cpp:506-743).  Each
sublevel runs as one launch of kernel K1 (ops/sublevel.py) on CUDA
tensors; planes too small for its stencil halo take K1's plain version, the
op path, as in the JAX package.

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
from .ops.sublevel import fused_supported, sublevel, sublevel_plain
from .plan import PipelinePlan


class OctaveData(NamedTuple):
    """Stacked per-sublevel planes of one octave: each [S, H, W], or
    [B, S, H, W] for a batch."""
    L: torch.Tensor
    det: torch.Tensor
    lx: torch.Tensor
    ly: torch.Tensor


def build_scale_space(image: torch.Tensor, plan: PipelinePlan
                      ) -> Tuple[List[OctaveData], torch.Tensor]:
    """Build the nonlinear scale space.

    Args:
      image: [H, W] or [B, H, W]; float32 in [0, 1] for the float path,
        int32 raw 0..255 for the 16.16 fixed-point path (the reference
        never normalises the fast path's input, main.cpp:257-258).  A batch
        builds all B pyramids with one K1 launch per sublevel.
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
    prev_L_last = None
    for oi, oct_plan in enumerate(plan.octaves):
        planes = []
        L_prev = None
        for sp in oct_plan.scales:
            kw = dict(diffusivity=cfg.diffusivity, fixed=fixed)
            if oi == 0 and sp.scale == 0:
                # first sublevel (akaze.cpp:325-353): contrast percentile
                # on a sigma=1 smooth, then L = the base smooth with
                # sigma = soffset (no diffusion)
                if fixed:
                    mag = scharr_magnitude_fixed(lowpass_fixed(x, 1.0, 5))
                    kcontrast = percentile_contrast_fixed(mag, cfg.per)
                else:
                    mag = scharr_magnitude(lowpass(x, 1.0, 5))
                    kcontrast = percentile_contrast(mag, cfg.per)
                ksz = 2 * math.ceil((cfg.soffset - 0.8) / 0.3) + 3
                kw.update(smooth_var=cfg.soffset * cfg.soffset,
                          smooth_radius=radius_for_ksize(ksz),
                          first_sublevel=True)
                src = x
            elif sp.scale == 0:
                # new octave (akaze.cpp:371-391): decay kcontrast, decimate
                # with the fused smooth, diffuse the full tau cycle
                if fixed:
                    kcontrast = (kcontrast.to(torch.float32) * 0.75
                                 + 0.5).to(torch.int32)
                    src, kw["smooth"] = down_with_smooth_fixed(prev_L_last)
                else:
                    kcontrast = kcontrast * 0.75
                    src, kw["smooth"] = down_with_smooth(prev_L_last)
            else:
                # next sublevel (akaze.cpp:393-420): sigma=1 smooth of the
                # previous L, conductivity, diffuse
                src = L_prev
            fused = fused_supported(*src.shape[-2:], sp.taus, sp.sigma_size,
                                    kw.get("smooth_radius", 2))
            outs = (sublevel if fused else sublevel_plain)(
                src, inverse_square(kcontrast), sp.taus, sp.sigma_size, **kw)
            planes.append(outs)
            L_prev = outs[0]
        prev_L_last = L_prev
        ax = 1 if batched else 0
        stacked = [torch.stack([p[i] if batched else p[i][0]
                                for p in planes], dim=ax)
                   for i in range(4)]
        octaves.append(OctaveData(*stacked))
    return octaves, (kcontrast if batched else kcontrast[0])
