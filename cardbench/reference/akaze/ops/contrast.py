"""Contrast factor estimation: percentile of the gradient magnitude (PyTorch).

Port of ``akaze_tpu/ops/contrast.py``, with the same bisected percentile
(contrast.py:41-69).  kcontrast feeds every
conductivity, so any other percentile algorithm would change every plane
of the scale space.  No atomics and no histogram scatter: nine masked
counting reductions find the percentile bin.
"""

from __future__ import annotations

import torch

NBINS = 300  # akazed.cu:8


def bisect_bin(count_le, hist0: torch.Tensor, npix: int, per: float):
    """Percentile bin via 9-step bisection: smallest m with
    #(1 <= bin <= m) >= trunc((npix - #(bin == 0)) * per).

    ``count_le(mid)``: #(bin <= mid) per leading index, for int32 ``mid``
    shaped like ``hist0`` (#(bin == 0)).  Returns k in [1, NBINS].  The
    counts may come from a whole plane or be summed over the row shards of
    one (``parallel/spatial.py``), with ``npix`` the global pixel count.
    """
    thresh = ((npix - hist0).to(torch.float32) * per).to(torch.int32)
    lo = torch.zeros_like(hist0)
    hi = torch.full_like(hist0, NBINS - 1)
    # invariant: cprime(hi) >= thresh (or hi == NBINS-1), cprime(lo-1) <
    # thresh; 2^9 = 512 > NBINS covers the range
    for _ in range(9):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        cprime = count_le(mid) - hist0
        ge = cprime >= thresh
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    return torch.clamp(lo + 1, max=NBINS)


def _percentile_bisect(bins: torch.Tensor, npix: int, per: float):
    """``bisect_bin`` over ``bins``: [..., H, W] int32 in [0, NBINS); one k
    per leading index."""
    flat = bins.flatten(-2)
    hist0 = (flat == 0).sum(-1, dtype=torch.int32)
    return bisect_bin(
        lambda mid: (flat <= mid[..., None]).sum(-1, dtype=torch.int32),
        hist0, npix, per)


def contrast_bins(grad: torch.Tensor, max_contrast: torch.Tensor,
                  fixed: bool):
    """(bins, hfactor) of the magnitudes ``grad`` for a floored maximum
    ``max_contrast`` (one per leading index of ``grad``).  Float: binning
    truncates toward zero (``__fmul_rz`` + int cast, akazed.cu:892-896),
    clamped to NBINS-1.  Fixed: the bin factor is quantized 16.16
    (akazed.cu:4138) and applied with ``>> 16``."""
    if fixed:
        hfactor = (torch.full(max_contrast.shape, NBINS, dtype=torch.float32,
                              device=grad.device)
                   / max_contrast.to(torch.float32) * 65536 + 0.5
                   ).to(torch.int32)
        bins = (grad * hfactor[..., None, None]) >> 16
    else:
        hfactor = torch.full_like(max_contrast, NBINS) / max_contrast
        bins = (grad * hfactor[..., None, None]).to(torch.int32)
    return torch.clamp(bins, 0, NBINS - 1), hfactor


def contrast_from_bin(k, max_contrast, hfactor, fixed: bool):
    """kcontrast of percentile bin ``k``: k / hfactor, or on the fixed
    path k * max_contrast // NBINS (integer division, akazed.cu:4169)."""
    if fixed:
        return torch.div(k * max_contrast, NBINS, rounding_mode="floor")
    return k.to(torch.float32) / hfactor


def contrast_floor(fixed: bool):
    """The floor of the maximum magnitude: 1 on the fixed path, else 0.03
    as the host seeds d_max_contrast (akazed.cu:2413-2417)."""
    return 1 if fixed else 0.03


def percentile_contrast(grad: torch.Tensor, per: float):
    """kcontrast = k / hfactor with hfactor = NBINS / max_contrast.

    ``grad``: [..., H, W] float32 gradient magnitudes; one kcontrast per
    leading index.  The max is floored at 0.03 (``contrast_floor``).
    """
    return _percentile(grad, per, False)


def percentile_contrast_fixed(grad: torch.Tensor, per: float):
    """Fixed-point path (akazed.cu:4098-4172).

    ``grad``: [..., H, W] int32 magnitudes.  The max is floored at 1.
    Returns int32 kcontrast, one per leading index.
    """
    return _percentile(grad, per, True)


def _percentile(grad, per: float, fixed: bool):
    h, w = grad.shape[-2:]
    max_contrast = torch.clamp(grad.flatten(-2).amax(-1),
                               min=contrast_floor(fixed))
    bins, hfactor = contrast_bins(grad, max_contrast, fixed)
    k = _percentile_bisect(bins, h * w, per)
    return contrast_from_bin(k, max_contrast, hfactor, fixed)
