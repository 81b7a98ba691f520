"""Perona-Malik conductivity and the FED diffusion step (PyTorch).

Port of ``akaze_tpu/ops/diffusion.py``.  Reference kernels: gFlowNaive
(akazed.cu:1068-1107; fixed point akazed.cu:3406-3446) and gNldStepNaive
(akazed.cu:1241-1264; fixed point akazed.cu:3449-3473).  Ops take
``[..., H, W]`` float32 tensors, or int32 for the ``*_fixed`` ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Diffusivity
from .conv import pad_reflect
from .scharr import scharr_gradient_xy


def _conductivity_from_dif2(dif2: torch.Tensor, diffusivity: Diffusivity):
    # true divisions: ``c / t`` on a tensor multiplies by its reciprocal
    one = torch.ones_like(dif2)
    if diffusivity == Diffusivity.PM_G1:
        return torch.exp(-dif2)
    if diffusivity == Diffusivity.PM_G2:
        return one / (1.0 + dif2)
    if diffusivity == Diffusivity.WEICKERT:
        d2 = dif2 * dif2
        return 1.0 - torch.exp(torch.full_like(dif2, -3.315) / (d2 * d2))
    # CHARBONNIER
    return one / torch.sqrt(1.0 + dif2)


def inverse_square(kcontrast: torch.Tensor) -> torch.Tensor:
    """ikc = 1 / kcontrast^2 as in hFlow (akazed.cu:2493), float32.  An
    int32 kcontrast (the fixed path) is squared in int32 first
    (``conductivity_fixed``'s expression order)."""
    k2 = (kcontrast * kcontrast).to(torch.float32)
    return torch.ones_like(k2) / k2


def conductivity_ikc(smooth: torch.Tensor, diffusivity: Diffusivity,
                     ikc: torch.Tensor):
    """g(|grad L_smooth|) given ikc = 1/kcontrast^2 (broadcast against
    ``smooth``)."""
    dx, dy = scharr_gradient_xy(smooth, 1)
    dif2 = ikc * (dx * dx + dy * dy)
    return _conductivity_from_dif2(dif2, diffusivity)


def conductivity(smooth: torch.Tensor, diffusivity: Diffusivity,
                 kcontrast: torch.Tensor):
    """g(|grad L_smooth|) with unnormalized Scharr gradients.

    ``kcontrast`` is a tensor broadcast against ``smooth`` (a scalar, or
    [B, 1, 1] for a batch)."""
    return conductivity_ikc(smooth, diffusivity, inverse_square(kcontrast))


def conductivity_fixed_ikc(smooth: torch.Tensor, diffusivity: Diffusivity,
                           ikc: torch.Tensor):
    """Fixed-point flow (akazed.cu:3406-3446): int Scharr gradient of the
    int32 ``smooth``, float conductivity, stored int(g * 65536 + 0.5)."""
    dx, dy = scharr_gradient_xy(smooth, 1)
    dif2 = (dx * dx + dy * dy).to(torch.float32) * ikc
    g = _conductivity_from_dif2(dif2, diffusivity)
    return (g * 65536 + 0.5).to(torch.int32)


def conductivity_fixed(smooth: torch.Tensor, diffusivity: Diffusivity,
                       kcontrast: torch.Tensor):
    """``conductivity_fixed_ikc`` for an int32 ``kcontrast``."""
    return conductivity_fixed_ikc(smooth, diffusivity,
                                  inverse_square(kcontrast))


def _neighbors4(x: torch.Tensor):
    """Reflect-101 centre/N/S/W/E views."""
    h, w = x.shape[-2:]
    xp = pad_reflect(pad_reflect(x, 1, -1), 1, -2)
    c = xp[..., 1:1 + h, 1:1 + w]
    n = xp[..., 0:h, 1:1 + w]
    s = xp[..., 2:2 + h, 1:1 + w]
    wv = xp[..., 1:1 + h, 0:w]
    e = xp[..., 1:1 + h, 2:2 + w]
    return c, n, s, wv, e


def half_tau(tau: float) -> float:
    """0.5 * tau in float32, the factor of one FED step."""
    return float(np.float32(0.5) * np.float32(tau))


def nld_step(img: torch.Tensor, flow: torch.Tensor, tau: float):
    """One explicit diffusion step (gNldStepNaive, akazed.cu:1241-1264):

    dst = img + 0.5*tau * sum_4nb (g_c + g_n) * (I_n - I_c)
    """
    ic, inn, iss, iww, iee = _neighbors4(img)
    fc, fnn, fss, fww, fee = _neighbors4(flow)
    step = ((fc + fee) * (iee - ic) + (fc + fww) * (iww - ic)
            + (fc + fss) * (iss - ic) + (fc + fnn) * (inn - ic))
    return img + half_tau(tau) * step


def step_factor(tau: float) -> int:
    """16.16 factor of one fixed FED step: int(0.5*tau*65536 + 0.5), each
    operation in float32 (``nld_step_fixed``)."""
    f32 = np.float32
    return int(np.int32(f32(0.5) * f32(tau) * f32(65536) + f32(0.5)))


def nld_step_fixed(img: torch.Tensor, flow: torch.Tensor, tau: float):
    """Fixed-point FED step (akazed.cu:3449-3473) on int32 planes:

    step = (sum_4nb (g_c + g_n) * (I_n - I_c)) >> 16;
    dst = ((stepfac * step) >> 16) + img, wrapping in int32.
    """
    ic, inn, iss, iww, iee = _neighbors4(img)
    fc, fnn, fss, fww, fee = _neighbors4(flow)
    step = ((fc + fee) * (iee - ic) + (fc + fww) * (iww - ic)
            + (fc + fss) * (iss - ic) + (fc + fnn) * (inn - ic)) >> 16
    return ((step_factor(tau) * step) >> 16) + img
