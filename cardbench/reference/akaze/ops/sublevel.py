"""K1's plain version: one octave of the nonlinear scale space.

A frozen copy of the port's ``sublevel_plain`` and ``octave_plain``
(``akaze_tpu_torch/ops/sublevel.py``): the composition of the plain ops
that one sublevel runs, a loop of them per octave.  ``octave`` is the
plain version itself; no kernel stands behind it.  Each plane a sublevel
makes passes ``precision.rounded``, a no-op unless the control asks for
a lower precision.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import Diffusivity
from ..precision import rounded
from .conv import (gauss_half_kernel, gauss_half_kernel_fixed, sep_conv2d,
                   sep_conv2d_fixed)
from .diffusion import (conductivity_fixed_ikc, conductivity_ikc, nld_step,
                        nld_step_fixed)
from .scharr import (hessian_determinant, hessian_determinant_fixed,
                     scaled_derivatives, scaled_derivatives_fixed)


class SublevelSpec(NamedTuple):
    """The static arguments of one sublevel."""
    taus: Tuple[float, ...]
    step: int
    smooth_var: float
    smooth_radius: int
    first_sublevel: bool


def octave_specs(oct_plan, base=None) -> Tuple[SublevelSpec, ...]:
    """Each sublevel's arguments.  ``base``: (variance, radius) of the
    first octave's base smooth, whose result is the first sublevel's L
    (akaze.cpp:325-332); None for later octaves, where sublevel 0 takes
    the decimation's smooth."""
    return tuple(SublevelSpec(
        tuple(sp.taus), int(sp.sigma_size),
        *(base if (base and i == 0) else (1.0, 2)),
        bool(base) and i == 0) for i, sp in enumerate(oct_plan.scales))


def sublevel_plain(src, ikc, taus, step: int, smooth=None,
                   smooth_var: float = 1.0, smooth_radius: int = 2,
                   first_sublevel: bool = False,
                   diffusivity: Diffusivity = Diffusivity.PM_G2,
                   fixed: bool = False):
    """The plain PyTorch version: the op path of one sublevel.  Same
    arguments and results as ``sublevel``."""
    if smooth is None:
        smooth = (sep_conv2d_fixed(src, gauss_half_kernel_fixed(
                      smooth_var, smooth_radius)) if fixed
                  else rounded(sep_conv2d(src, gauss_half_kernel(
                      smooth_var, smooth_radius))))
    if taus:
        flow = (conductivity_fixed_ikc if fixed else conductivity_ikc)(
            smooth, diffusivity, ikc[:, None, None])
        L = src
        for tau in taus:
            L = rounded((nld_step_fixed if fixed else nld_step)(L, flow, tau))
    else:
        L = smooth if first_sublevel else src
    if fixed:
        lx, ly = scaled_derivatives_fixed(smooth, step)
        det = hessian_determinant_fixed(lx, ly, step)
    else:
        lx, ly = map(rounded, scaled_derivatives(smooth, step))
        det = rounded(hessian_determinant(lx, ly, step))
    return L, det, lx, ly


def octave_plain(src, ikc, oct_plan, smooth=None, base=None,
                 diffusivity: Diffusivity = Diffusivity.PM_G2,
                 fixed: bool = False):
    """The plain version of a whole octave: ``sublevel_plain`` once per
    sublevel, each taking the previous one's L, stacked into one
    [4, B, S, H, W] tensor.  Same arguments and results as ``octave``."""
    specs = octave_specs(oct_plan, base)
    b, h, w = src.shape
    out = torch.empty((4, b, len(specs), h, w), dtype=src.dtype,
                      device=src.device)
    L = src
    for s, sp in enumerate(specs):
        planes = sublevel_plain(
            L, ikc, sp.taus, sp.step, smooth=smooth if s == 0 else None,
            smooth_var=sp.smooth_var, smooth_radius=sp.smooth_radius,
            first_sublevel=sp.first_sublevel, diffusivity=diffusivity,
            fixed=fixed)
        for k in range(4):
            out[k, :, s] = planes[k]
        L = planes[0]
    return tuple(out.unbind(0))


def octave(src, ikc, oct_plan, smooth=None, base=None,
           diffusivity: Diffusivity = Diffusivity.PM_G2,
           fixed: bool = False):
    """Every sublevel of one octave (the port's ``octave`` on a CPU
    tensor): (L, det, lx, ly), each [B, S, H, W]."""
    base = None if base is None else (float(base[0]), int(base[1]))
    return octave_plain(src, ikc, oct_plan, smooth, base,
                        Diffusivity(diffusivity), bool(fixed))
