"""Separable Gaussian convolutions with reflect-101 borders (PyTorch).

Port of ``akaze_tpu/ops/conv.py``.  The reference implements these as
shared-memory CUDA kernels (gConv2d / gConv2dR2, akazed.cu:205-356;
16.16 fixed point at akazed.cu:2786-3076); the border rule ``abs(i - d)``
on the left and ``borderAdd`` on the right (akazed.cu:162-170) is
reflect-101: the edge sample is not repeated.

Every op takes ``[..., H, W]`` tensors (float32, or int32 for the
``*_fixed`` ops), so a leading batch axis passes straight through.  The
expression order of ``_row_pass`` / ``_col_pass`` is the JAX package's
(conv.py:58-74), so the two agree to the last bit wherever neither side
contracts a multiply-add; int32 arithmetic wraps on both sides.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def gauss_half_kernel(var: float, radius: int) -> Tuple[float, ...]:
    """Normalized half Gaussian kernel [k0..kR].

    Matches createGaussKernel (akazed.cu:2298-2333): k[i] = exp(-i^2/(2 var)),
    normalized so that k0 + 2*sum(k[1:]) == 1.
    """
    denom = 1.0 / (2.0 * var)
    k = [math.exp(-i * i * denom) for i in range(radius + 1)]
    ksum = k[0] + 2.0 * sum(k[1:])
    return tuple(v / ksum for v in k)


@lru_cache(maxsize=None)
def gauss_half_kernel_fixed(var: float, radius: int) -> Tuple[int, ...]:
    """16.16 fixed-point half kernel: int(kf * 65536 + 0.5)
    (akazed.cu:3861-3900)."""
    return tuple(int(v * 65536 + 0.5) for v in gauss_half_kernel(var, radius))


def f32_taps(half_kernel) -> Tuple[float, ...]:
    """The half kernel rounded to float32, as kernels and tensors use it."""
    return tuple(float(np.float32(v)) for v in half_kernel)


def radius_for_ksize(ksz: int) -> int:
    """Kernel-size -> radius dispatch of hLowPass (akazed.cu:2345-2380)."""
    if ksz <= 5:
        return 2
    if ksz <= 7:
        return 3
    if ksz <= 9:
        return 4
    if ksz <= 11:
        return 5
    raise ValueError("kernels larger than 11 not supported (akazed.cu:2379)")


def mirror_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of a reflect-101 padding by ``r`` of an axis of length ``n``:
    one mirror on each side (``i < 0 -> -i``, ``i >= n -> 2n-2-i``)."""
    if r >= n:
        raise ValueError(f"reflect padding of {r} needs an axis longer than "
                         f"that, got {n}")
    i = torch.arange(-r, n + r, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def pad_reflect(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Reflect-101 pad ``x`` by ``r`` on both sides of ``dim``."""
    if r == 0:
        return x
    return x.index_select(dim, mirror_index(x.shape[dim], r, x.device))


def _row_pass(xp, k, w):
    """Horizontal stencil over a width-padded array; returns [..., H, w]."""
    r = len(k) - 1
    out = k[0] * xp[..., :, r:r + w]
    for i in range(1, r + 1):
        out = out + k[i] * (xp[..., :, r - i:r - i + w]
                            + xp[..., :, r + i:r + i + w])
    return out


def _col_pass(xp, k, h):
    r = len(k) - 1
    out = k[0] * xp[..., r:r + h, :]
    for i in range(1, r + 1):
        out = out + k[i] * (xp[..., r - i:r - i + h, :]
                            + xp[..., r + i:r + i + h, :])
    return out


def sep_conv2d(x: torch.Tensor, half_kernel: Tuple[float, ...]):
    """Separable 2D convolution.  x: [..., H, W] float32."""
    r = len(half_kernel) - 1
    h, w = x.shape[-2:]
    k = f32_taps(half_kernel)
    row = _row_pass(pad_reflect(x, r, -1), k, w)
    return _col_pass(pad_reflect(row, r, -2), k, h)


def sep_conv2d_fixed(x: torch.Tensor, half_kernel: Tuple[int, ...]):
    """Separable 2D convolution, 16.16 fixed point.  x: [..., H, W] int32.
    Each pass accumulates int32 products and shifts ``>> 16``
    (arithmetic), as the reference does per stage (akazed.cu:2812-2850)."""
    r = len(half_kernel) - 1
    h, w = x.shape[-2:]
    row = _row_pass(pad_reflect(x, r, -1), half_kernel, w) >> 16
    return _col_pass(pad_reflect(row, r, -2), half_kernel, h) >> 16


def lowpass(x: torch.Tensor, var: float, ksz: int):
    """hLowPass semantics (akazed.cu:2336-2386): radius from ksz, Gaussian
    from ``var``."""
    return sep_conv2d(x, gauss_half_kernel(var, radius_for_ksize(ksz)))


def lowpass_fixed(x: torch.Tensor, var: float, ksz: int):
    """Fixed-point hLowPass (akazed.cu:3963-4013)."""
    return sep_conv2d_fixed(x, gauss_half_kernel_fixed(var,
                                                       radius_for_ksize(ksz)))


def _even_cols(x, off: int, n: int):
    return x[..., :, off:off + 2 * n:2]


def _even_rows(x, off: int, n: int):
    return x[..., off:off + 2 * n:2, :]


def down_with_smooth(src: torch.Tensor):
    """2x decimation plus sigma=1 (radius 2) smooth of the decimated grid.

    Matches gDownWithSmooth (akazed.cu:449-511): ``dst`` is the raw
    even-index decimation of ``src``; ``smooth`` applies the radius-2
    Gaussian *in source coordinates* with taps at +-2, +-4 and reflect-101
    borders on the source grid.

    Returns (dst, smooth), each [..., H//2, W//2].
    """
    return _down_with_smooth(src, f32_taps(gauss_half_kernel(1.0, 2)), 0)


def down_with_smooth_fixed(src: torch.Tensor):
    """Fixed-point gDownWithSmooth (akazed.cu:3143-3205): int32 ``src``,
    16.16 taps, ``>> 16`` after each pass."""
    return _down_with_smooth(src, gauss_half_kernel_fixed(1.0, 2), 16)


def _down_with_smooth(src, k, shift: int):
    hs, ws = src.shape[-2:]
    hd, wd = hs >> 1, ws >> 1
    dst = _even_rows(_even_cols(src, 0, wd), 0, hd)

    xp = pad_reflect(src, 4, -1)
    # row filter sampled at even source columns: source col = 2*dix + 2i
    row = k[0] * _even_cols(xp, 4, wd)
    for i in (1, 2):
        row = row + k[i] * (_even_cols(xp, 4 - 2 * i, wd)
                            + _even_cols(xp, 4 + 2 * i, wd))
    rowp = pad_reflect(row >> shift if shift else row, 4, -2)
    smooth = k[0] * _even_rows(rowp, 4, hd)
    for i in (1, 2):
        smooth = smooth + k[i] * (_even_rows(rowp, 4 - 2 * i, hd)
                                  + _even_rows(rowp, 4 + 2 * i, hd))
    if shift:
        smooth = smooth >> shift
    return dst.contiguous(), smooth.contiguous()
