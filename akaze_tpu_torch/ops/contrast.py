"""Contrast factor estimation: percentile of the gradient magnitude (PyTorch).

Port of the float half of ``akaze_tpu/ops/contrast.py``, with the same
bisected percentile (contrast.py:41-69).  kcontrast feeds every
conductivity, so any other percentile algorithm would change every plane
of the scale space.  No atomics and no histogram scatter: nine masked
counting reductions find the percentile bin.
"""

from __future__ import annotations

import torch

NBINS = 300  # akazed.cu:8


def _percentile_bisect(bins: torch.Tensor, npix: int, per: float):
    """Percentile bin via 9-step bisection: smallest m with
    #(1 <= bin <= m) >= trunc((npix - #(bin == 0)) * per).

    ``bins``: [..., H, W] int32 in [0, NBINS).  Returns k in [1, NBINS],
    one per leading index.
    """
    flat = bins.flatten(-2)
    hist0 = (flat == 0).sum(-1, dtype=torch.int32)
    thresh = ((npix - hist0).to(torch.float32) * per).to(torch.int32)
    lo = torch.zeros_like(hist0)
    hi = torch.full_like(hist0, NBINS - 1)
    # invariant: cprime(hi) >= thresh (or hi == NBINS-1), cprime(lo-1) <
    # thresh; 2^9 = 512 > NBINS covers the range
    for _ in range(9):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        cprime = (flat <= mid[..., None]).sum(-1, dtype=torch.int32) - hist0
        ge = cprime >= thresh
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    return torch.clamp(lo + 1, max=NBINS)


def percentile_contrast(grad: torch.Tensor, per: float):
    """kcontrast = k / hfactor with hfactor = NBINS / max_contrast.

    ``grad``: [..., H, W] float32 gradient magnitudes; one kcontrast per
    leading index.  The max is floored at 0.03 exactly as the host seeds
    d_max_contrast (akazed.cu:2413-2417).  Binning truncates toward zero
    (``__fmul_rz`` + int cast, akazed.cu:892-896), clamped to NBINS-1.
    """
    h, w = grad.shape[-2:]
    max_contrast = torch.clamp(grad.flatten(-2).amax(-1), min=0.03)
    hfactor = torch.full_like(max_contrast, NBINS) / max_contrast
    bins = torch.clamp((grad * hfactor[..., None, None]).to(torch.int32),
                       0, NBINS - 1)
    k = _percentile_bisect(bins, h * w, per)
    return k.to(torch.float32) / hfactor
