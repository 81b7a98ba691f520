"""Perona-Malik conductivity and the FED diffusion step (PyTorch).

Port of the float half of ``akaze_tpu/ops/diffusion.py``.  Reference
kernels: gFlowNaive (akazed.cu:1068-1107) and gNldStepNaive
(akazed.cu:1241-1264).  Ops take ``[..., H, W]`` float32 tensors.
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
    """ikc = 1 / kcontrast^2 as in hFlow (akazed.cu:2493)."""
    return torch.ones_like(kcontrast) / (kcontrast * kcontrast)


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
