"""Debug hooks: inspect every intermediate plane.

Port of ``akaze_tpu/debug.py``.  The reference's compile-time
``DEBUG_SHOW`` path copies each intermediate (nonlinear image, Hessian
determinant, derivatives, response/size/layer maps) into cv::Mats after
every kernel (akaze.cpp:7-11, 293-298, 334-351, 378-390, 441-445).  Here
``debug_planes`` returns all of them as numpy arrays, keyed and typed as
the JAX package's, and ``dump_planes`` renders them to PNGs.  On the card
the scale space runs K1 with the launches of
``Akaze.detect_and_compute(image, describe=False)``; every plane is copied
to the host only at the end.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .detect import build_extrema_maps, nms
from .pipeline import _as_images
from .plan import PipelinePlan
from .scale_space import build_scale_space


def debug_planes(image, plan: PipelinePlan, fixed: bool = False,
                 device=None) -> Dict[str, np.ndarray]:
    """Run the scale space and the detection front half of one [H, W]
    image (float in [0, 1], or raw 0..255 with ``fixed``) and return every
    intermediate plane, keyed like the reference's debug mats:

      kcontrast                                     the contrast factor
      L{o}_{s}, det{o}_{s}, lx{o}_{s}, ly{o}_{s}   per sublevel
      response_map, size_map, layer_map             full resolution
      nms_mask                                      full resolution, bool

    ``device``: where it runs (default: a tensor's own device, else the
    card).
    """
    x = _as_images(image, device, fixed)
    octaves, kcontrast = build_scale_space(x, plan)
    resp, size, layer = build_extrema_maps(octaves, plan)
    mask = nms(resp, size, layer, plan)
    planes = {"kcontrast": kcontrast}
    for oi, o in enumerate(octaves):
        for si in range(o.L.shape[0]):
            planes[f"L{oi}_{si}"] = o.L[si]
            planes[f"det{oi}_{si}"] = o.det[si]
            planes[f"lx{oi}_{si}"] = o.lx[si]
            planes[f"ly{oi}_{si}"] = o.ly[si]
    planes.update(response_map=resp, size_map=size, layer_map=layer,
                  nms_mask=mask)
    return {k: v.cpu().numpy() for k, v in planes.items()}


def dump_planes(planes: Dict[str, np.ndarray], out_dir: str) -> None:
    """Render each 2-D plane to a normalised grayscale PNG in
    ``out_dir``."""
    from .viz import write_png

    os.makedirs(out_dir, exist_ok=True)
    for name, arr in planes.items():
        a = np.asarray(arr, np.float64)
        if a.ndim != 2:
            continue
        lo, hi = np.nanmin(a), np.nanmax(a)
        norm = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
        write_png(os.path.join(out_dir, f"{name}.png"),
                  (norm * 255).astype(np.uint8))
