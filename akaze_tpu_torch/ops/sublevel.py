"""Kernel K1: one whole scale-space sublevel per launch.

Replaces ``akaze_tpu/ops/pallas_sublevel.py:fused_sublevel_batch`` (and its
single-image form ``fused_sublevel``: here B = 1).  The CUDA kernel is
``csrc/sublevel.cu``; its header says what bounds it on the card and what
its design does about that.

``sublevel`` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs ``sublevel_plain``, the composition of the
ported ops that the scale space's op path uses (scale_space.py:155-211 of
the JAX package).  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..config import Diffusivity
from .conv import f32_taps, gauss_half_kernel, sep_conv2d
from .diffusion import conductivity_ikc, half_tau, nld_step
from .scharr import hessian_determinant, scaled_derivatives

# Largest halo of one launch (csrc/sublevel.cu MAX_HALO): four 96x96 f32
# buffers, 147 KB of the 227 KB of shared memory one block may use.
MAX_HALO = 32


def halo_for(step: int, n_taus: int, smooth_radius: int = 2) -> int:
    """Stencil reach of one fused sublevel (``_halo_for`` of the JAX
    package without its 8-row TPU alignment): det needs the smooth at
    +-2*step and the smooth needs the input +-smooth_radius; the FED chain
    needs the flow at +-n, the flow the smooth at +-(n+1), and so the input
    at +-(n + smooth_radius + 1)."""
    return max(2 * step + smooth_radius, n_taus + smooth_radius + 1)


def fused_supported(h: int, w: int, taus, step: int,
                    smooth_radius: int = 2) -> bool:
    """Whether the kernel can run this plane: each reflect halo must be a
    single mirror, so both sides must exceed the halo.  Smaller planes take
    the op path, as they do in the JAX package.  The halo is the whole
    sublevel's reach, as there, even where ``chain_launches`` splits the
    chain into launches of smaller halo."""
    halo = halo_for(step, len(taus), smooth_radius)
    return h > halo + 1 and w > halo + 1


def chain_launches(taus, step: int, smooth_radius: int = 2):
    """The FED chain split into the K1 launches that run it, as
    (taus, halo) per launch: each launch's halo is at most ``MAX_HALO``.
    The first launch also takes the derivatives; the others continue the
    chain from the previous launch's L.  Up to 29 steps (every sublevel of
    four octaves of a 960x1280 image) take one launch; longer chains are
    split into launches of near-equal length."""
    if 2 * step + smooth_radius > MAX_HALO:
        raise ValueError(f"derivative step {step} needs a halo over "
                         f"{MAX_HALO}")
    taus = tuple(taus)
    most = MAX_HALO - smooth_radius - 1         # steps one launch can take
    size = -(-len(taus) // -(-len(taus) // most)) if taus else 1
    chunks = [taus[i:i + size] for i in range(0, len(taus), size)] or [()]
    return [(c, halo_for(step, len(c), smooth_radius) if i == 0
             else len(c) + smooth_radius + 1)
            for i, c in enumerate(chunks)]


def sublevel_plain(src, ikc, taus, step: int, smooth=None,
                   smooth_var: float = 1.0, smooth_radius: int = 2,
                   first_sublevel: bool = False,
                   diffusivity: Diffusivity = Diffusivity.PM_G2):
    """The plain PyTorch version: the op path of one sublevel.  Same
    arguments and results as ``sublevel``."""
    if smooth is None:
        smooth = sep_conv2d(src, gauss_half_kernel(smooth_var,
                                                   smooth_radius))
    if taus:
        flow = conductivity_ikc(smooth, diffusivity, ikc[:, None, None])
        L = src
        for tau in taus:
            L = nld_step(L, flow, tau)
    else:
        L = smooth if first_sublevel else src
    lx, ly = scaled_derivatives(smooth, step)
    det = hessian_determinant(lx, ly, step)
    return L, det, lx, ly


def _launch(src, ikc, taus, step, smooth, smooth_var, smooth_radius,
            first_sublevel, diffusivity):
    b, h, w = src.shape
    if not fused_supported(h, w, taus, step, smooth_radius):
        raise ValueError(f"plane {h}x{w} too small for halo "
                         f"{halo_for(step, len(taus), smooth_radius)}; "
                         f"guard calls with fused_supported()")
    L, det, lx, ly = (torch.empty_like(src) for _ in range(4))
    kern = np.asarray(f32_taps(gauss_half_kernel(smooth_var, smooth_radius)),
                      np.float32)
    lib = _build.library()
    L_in = None
    for i, (chunk, halo) in enumerate(chain_launches(taus, step,
                                                     smooth_radius)):
        if i:
            L_in, L = L, torch.empty_like(src)
        half = np.asarray([half_tau(t) for t in chunk] or [0.0], np.float32)
        with torch.cuda.device(src.device):
            err = lib.akaze_sublevel(
                _build.ptr(src), _build.ptr(smooth), _build.ptr(L_in),
                _build.ptr(ikc), *(_build.ptr(o) for o in (L, det, lx, ly)),
                b, h, w, halo, step, int(diffusivity), int(first_sublevel),
                int(i == 0), len(chunk), half.ctypes.data, smooth_radius,
                kern.ctypes.data, _build.stream_of(src))
        _build.check(err, "sublevel_kernel")
        sublevel.launches += 1
    return L, det, lx, ly


def sublevel(src: torch.Tensor, ikc: torch.Tensor, taus: Tuple[float, ...],
             step: int, smooth: Optional[torch.Tensor] = None,
             smooth_var: float = 1.0, smooth_radius: int = 2,
             first_sublevel: bool = False,
             diffusivity: Diffusivity = Diffusivity.PM_G2):
    """One scale-space sublevel for a batch of images.

    Args:
      src: [B, H, W] float32, the previous sublevel's L (or the decimated
        image of an octave start, or the input image for the first
        sublevel).
      ikc: [B] float32, 1 / kcontrast^2 per image.
      taus: FED step sizes.
      step: sigma_size, the stride of the derivative stencils.
      smooth: optional [B, H, W] float32 sigma-1 smooth (octave starts get
        it from ``down_with_smooth``); otherwise a Gaussian of
        (``smooth_var``, ``smooth_radius``) is taken of ``src``.
      first_sublevel: L = the smooth (the base lowpass, akaze.cpp:325-332).

    Returns (L, det, lx, ly), each [B, H, W] float32.
    """
    if src.dim() != 3:
        raise ValueError(f"src must be [B, H, W], got {tuple(src.shape)}")
    dev = src.device
    f32 = torch.float32
    _build.check_tensor("src", src, f32, src.shape, dev)
    _build.check_tensor("ikc", ikc, f32, src.shape[:1], dev)
    if smooth is not None:
        _build.check_tensor("smooth", smooth, f32, src.shape, dev)
    args = (src, ikc, tuple(taus), int(step), smooth, smooth_var,
            smooth_radius, first_sublevel, Diffusivity(diffusivity))
    if dev.type == "cpu":
        return sublevel_plain(*args)
    if dev.type == "cuda":
        return _launch(*args)
    raise ValueError(f"no sublevel kernel for device {dev}")


sublevel.launches = 0
