"""Scharr derivatives, gradient magnitude and Hessian determinant (PyTorch).

Port of the float half of ``akaze_tpu/ops/scharr.py``.  Reference kernels:
gScharrContrastNaive (akazed.cu:644-667), gDerivate (akazed.cu:1267-1296),
gHessianDeterminant (akazed.cu:1299-1331).

The unnormalized Scharr weights are 10 (center) and 3 (diagonals); the
scaled derivative kernels use fac1 = 1/(2*(10/3+2)) and fac2 = (10/3)*fac1
(akazed.cu:2537-2539) with the sampling step dilated by ``sigma_size``.
All borders are reflect-101.  Ops take ``[..., H, W]`` float32 tensors.
"""

from __future__ import annotations

import torch

from .conv import pad_reflect

SCHARR_FAC1 = 1.0 / (2.0 * (10.0 / 3.0 + 2.0))   # 0.09375
SCHARR_FAC2 = (10.0 / 3.0) * SCHARR_FAC1         # 0.3125


def _shift9(x: torch.Tensor, step: int):
    """The 9 reflect-101 shifted views of x at offsets in {-step, 0, +step},
    keyed by (dy, dx) in {-1, 0, 1} (units of ``step``)."""
    h, w = x.shape[-2:]
    xp = pad_reflect(pad_reflect(x, step, -1), step, -2)
    out = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            y0 = step + dy * step
            x0 = step + dx * step
            out[(dy, dx)] = xp[..., y0:y0 + h, x0:x0 + w]
    return out


def scharr_gradient_xy(x: torch.Tensor, step: int = 1):
    """Unnormalized Scharr gradients (weights 10/3), reflect-101 borders."""
    v = _shift9(x, step)
    dx = 10 * (v[(0, 1)] - v[(0, -1)]) + 3 * (v[(-1, 1)] + v[(1, 1)]
                                              - v[(-1, -1)] - v[(1, -1)])
    dy = 10 * (v[(1, 0)] - v[(-1, 0)]) + 3 * (v[(1, -1)] + v[(1, 1)]
                                              - v[(-1, -1)] - v[(-1, 1)])
    return dx, dy


def scharr_magnitude(x: torch.Tensor):
    """|grad| with unnormalized Scharr weights (gScharrContrastNaive)."""
    dx, dy = scharr_gradient_xy(x, 1)
    return torch.sqrt(dx * dx + dy * dy)


def scaled_derivatives(x: torch.Tensor, step: int):
    """gDerivate (akazed.cu:1267-1296): normalized Scharr first derivatives
    with sampling step ``step``.  Returns (Lx, Ly)."""
    v = _shift9(x, step)
    lx = SCHARR_FAC1 * (v[(-1, 1)] + v[(1, 1)] - v[(-1, -1)] - v[(1, -1)]) \
        + SCHARR_FAC2 * (v[(0, 1)] - v[(0, -1)])
    ly = SCHARR_FAC1 * (v[(1, 1)] + v[(1, -1)] - v[(-1, 1)] - v[(-1, -1)]) \
        + SCHARR_FAC2 * (v[(1, 0)] - v[(-1, 0)])
    return lx, ly


def hessian_determinant(lx: torch.Tensor, ly: torch.Tensor, step: int):
    """gHessianDeterminant (akazed.cu:1299-1331): second derivatives from
    (Lx, Ly) with the same dilated stencil; det = Lxx*Lyy - Lxy^2."""
    vx = _shift9(lx, step)
    vy = _shift9(ly, step)
    f1, f2 = SCHARR_FAC1, SCHARR_FAC2
    dxx = f1 * (vx[(-1, 1)] + vx[(1, 1)] - vx[(-1, -1)] - vx[(1, -1)]) \
        + f2 * (vx[(0, 1)] - vx[(0, -1)])
    dxy = f1 * (vx[(1, 1)] + vx[(1, -1)] - vx[(-1, 1)] - vx[(-1, -1)]) \
        + f2 * (vx[(1, 0)] - vx[(-1, 0)])
    dyy = f1 * (vy[(1, 1)] + vy[(1, -1)] - vy[(-1, 1)] - vy[(-1, -1)]) \
        + f2 * (vy[(1, 0)] - vy[(-1, 0)])
    return dxx * dyy - dxy * dxy
