"""Kernel K1: the nonlinear scale space, one octave at a time.

Replaces ``akaze_tpu/ops/pallas_sublevel.py:fused_sublevel_batch`` (and its
single-image form ``fused_sublevel``: here B = 1).  The CUDA kernels are in
``csrc/sublevel.cu``; its header says what bounds them on the card and
what their design does about that.  Two kernels serve K1:

* the octave-resident kernel runs every sublevel of an octave in one
  launch, the octave held in one thread-block cluster's shared memory;
  it serves every octave whose four working planes fit there
  (``routes_resident``: planes of up to 40,000 px);
* the tiled kernel runs one sublevel per launch (more where
  ``chain_launches`` splits a long FED chain) for the larger octaves.

The rule is fixed, computed from the plan; nothing else chooses.

``octave`` is the wrapper the scale space calls: on a CUDA tensor it
launches the kernels (or raises), on a CPU tensor it runs ``octave_plain``,
a loop of ``sublevel_plain``, the composition of the ported ops that the
scale space's op path uses (scale_space.py:155-211 of the JAX package).
``sublevel`` is the tiled kernel's wrapper for one sublevel.  There is no
fallback from a kernel to a plain version.  Both kernels write L, det, Lx
and Ly straight into one [4, B, S, H, W] allocation per octave.

``octave.launches`` counts the resident kernel's launches and
``sublevel.launches`` the tiled kernel's; ``launches()`` is their sum.

Two flavours, as in the JAX kernel: float32 planes, and the 16.16 fixed
point of the reference's fast path (``fixed=True``: int32 planes, integer
smoothing, FED and derivatives with ``>> 16``, float conductivity stored
x65536; akazed.cu:3406-3473).  Each CUDA kernel serves both, templated on
the plane type.

Host work is done once: the launch parameters of an octave (taps, FED
factors, chain split, routing) are built on its first use and cached per
(octave plan, flavour), so a launch costs one ``ctypes`` call.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import ctypes

import numpy as np
import torch

from .. import _build
from ..config import Diffusivity
from .conv import (f32_taps, gauss_half_kernel, gauss_half_kernel_fixed,
                   sep_conv2d, sep_conv2d_fixed)
from .diffusion import (conductivity_fixed_ikc, conductivity_ikc, half_tau,
                        nld_step, nld_step_fixed, step_factor)
from .scharr import (hessian_determinant, hessian_determinant_fixed,
                     scaled_derivatives, scaled_derivatives_fixed)

# Largest halo of one tiled launch (csrc/sublevel.cu MAX_HALO): four
# 128x96 4-byte buffers, 196 KB of the 227 KB of shared memory one block
# may use.
MAX_HALO = 32
MAX_RADIUS = 5       # csrc/sublevel.cu MAX_RADIUS
MAX_SCALES = 8       # sublevels per octave the resident kernel takes
# The resident kernel: CTAs per image (16, a cluster size Hopper allows
# as non-portable), the shared memory each may hold for its band of the
# four working planes (of the 227 KB one block may use) ...
RESIDENT_CLUSTER = 16
RESIDENT_CTA_BYTES = 220 * 1024
# ... and the largest plane it takes.  Measured on an H100 (PERF.md): at
# 120x160 the resident kernel beats the tiled one, at 240x320 the tiled
# kernel is faster, so the threshold lies between.
RESIDENT_MAX_PIXELS = 40000
# FED steps the resident kernel runs per halo exchange (csrc/sublevel.cu)
FED_DEPTH = 4
# FED steps of one octave the resident kernel keeps in shared memory (five
# octaves of 1280x1920: 179)
MAX_OCTAVE_TAUS = 1024


def halo_for(step: int, n_taus: int, smooth_radius: int = 2) -> int:
    """Stencil reach of one fused sublevel (``_halo_for`` of the JAX
    package without its 8-row TPU alignment): det needs the smooth at
    +-2*step and the smooth needs the input +-smooth_radius; the FED chain
    needs the flow at +-n, the flow the smooth at +-(n+1), and so the input
    at +-(n + smooth_radius + 1)."""
    return max(2 * step + smooth_radius, n_taus + smooth_radius + 1)


def fused_supported(h: int, w: int, taus, step: int,
                    smooth_radius: int = 2) -> bool:
    """Whether the tiled kernel can run this plane: each reflect halo must
    be a single mirror, so both sides must exceed the halo.  The halo is
    the whole sublevel's reach, as in the JAX package, even where
    ``chain_launches`` splits the chain into launches of smaller halo."""
    halo = halo_for(step, len(taus), smooth_radius)
    return h > halo + 1 and w > halo + 1


def resident_fits(h: int, w: int, nscales: int, reach: int = 4) -> bool:
    """The routing rule: an octave runs on the resident kernel when its
    plane has at most ``RESIDENT_MAX_PIXELS`` pixels and each CTA's band
    of its four 4-byte working planes, with ``reach`` halo rows above and
    below, fits its shared memory.  960x1280: octave 3; 1280x1920 with
    five octaves: octaves 3-4."""
    rows = -(-h // RESIDENT_CLUSTER) + 2 * reach
    return (nscales <= MAX_SCALES and h * w <= RESIDENT_MAX_PIXELS
            and 16 * rows * w + 4 * MAX_OCTAVE_TAUS <= RESIDENT_CTA_BYTES)


def octave_reach(oct_plan, base=None) -> int:
    """Halo rows of the resident kernel: the largest derivative step or
    smoothing radius of the octave's sublevels, and at least the FED steps
    it runs per halo exchange."""
    return max(FED_DEPTH, *(max(sp.step, sp.smooth_radius)
                            for sp in octave_specs(oct_plan, base)))


def routes_resident(oct_plan, base=None) -> bool:
    """Whether K1 runs this octave on the resident kernel."""
    return (sum(len(sp.taus) for sp in oct_plan.scales) <= MAX_OCTAVE_TAUS
            and resident_fits(oct_plan.height, oct_plan.width,
                              len(oct_plan.scales),
                              octave_reach(oct_plan, base)))


def chain_launches(taus, step: int, smooth_radius: int = 2):
    """The FED chain split into the tiled launches that run it, as
    (taus, halo) per launch: each launch's halo is at most ``MAX_HALO``.
    The first launch also takes the derivatives; the others continue the
    chain from the previous launch's L.  Up to 29 steps take one launch;
    longer chains are split into launches of near-equal length.  Resident
    octaves never split."""
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


def octave_launches(oct_plan, base=None) -> int:
    """K1 launches of one octave on the card: one when it is resident,
    else the tiled launches of every sublevel."""
    if routes_resident(oct_plan, base):
        return 1
    return sum(len(chain_launches(sp.taus, sp.sigma_size))
               for sp in oct_plan.scales)


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
                  else sep_conv2d(src, gauss_half_kernel(smooth_var,
                                                         smooth_radius)))
    if taus:
        flow = (conductivity_fixed_ikc if fixed else conductivity_ikc)(
            smooth, diffusivity, ikc[:, None, None])
        L = src
        for tau in taus:
            L = (nld_step_fixed if fixed else nld_step)(L, flow, tau)
    else:
        L = smooth if first_sublevel else src
    if fixed:
        lx, ly = scaled_derivatives_fixed(smooth, step)
        det = hessian_determinant_fixed(lx, ly, step)
    else:
        lx, ly = scaled_derivatives(smooth, step)
        det = hessian_determinant(lx, ly, step)
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


# --------------------------------------------------------------------------
# launch parameters, built once
# --------------------------------------------------------------------------

def _bits(values, fixed: bool) -> np.ndarray:
    """Values of the plane type as int32 words: 16.16 integers as they
    are, floats as their float32 bits."""
    if fixed:
        return np.asarray(values, np.int64).astype(np.int32)
    return np.asarray(values, np.float32).view(np.int32)


def _taps(var: float, radius: int, fixed: bool):
    return (gauss_half_kernel_fixed(var, radius) if fixed
            else f32_taps(gauss_half_kernel(var, radius)))


def _factors(taus, fixed: bool):
    return [(step_factor if fixed else half_tau)(t) for t in taus]


class TiledLaunch(NamedTuple):
    params: np.ndarray     # csrc/sublevel.cu TiledParams, int32 words
    ptr: int               # its address, for the C call
    write_derivs: bool


@lru_cache(maxsize=None)
def tiled_launches(h: int, w: int, spec: SublevelSpec,
                   diffusivity: Diffusivity, fixed: bool
                   ) -> Tuple[TiledLaunch, ...]:
    """The tiled kernel's launches of one sublevel (``chain_launches``),
    each with its parameter block."""
    out = []
    kern = _bits(_taps(spec.smooth_var, spec.smooth_radius, fixed), fixed)
    for i, (chunk, halo) in enumerate(chain_launches(spec.taus, spec.step,
                                                     spec.smooth_radius)):
        p = np.zeros(10 + MAX_HALO + MAX_RADIUS + 1, np.int32)
        p[:10] = (int(fixed), h, w, halo, spec.step, int(diffusivity),
                  int(spec.first_sublevel), int(i == 0), len(chunk),
                  spec.smooth_radius)
        p[10:10 + len(chunk)] = _bits(_factors(chunk, fixed), fixed)
        p[10 + MAX_HALO:10 + MAX_HALO + len(kern)] = kern
        out.append(TiledLaunch(p, p.ctypes.data, i == 0))
    return tuple(out)


def _strides(*values) -> ctypes.Array:
    return (ctypes.c_longlong * 5)(*values)


class OctaveSetup(NamedTuple):
    """Everything static about one octave's K1 launches."""
    resident: bool
    shape: Tuple[int, int, int]          # (S, H, W)
    # resident: csrc/sublevel.cu OctaveParams and the FED factors of every
    # sublevel (plane type), copied to each device once
    params: Optional[np.ndarray]
    params_ptr: int
    factors: Optional[torch.Tensor]
    device_factors: dict
    # tiled: per sublevel, its launches and the batch strides of the first
    tiled: Tuple[Tuple[TiledLaunch, ...], ...]
    strides: Tuple[ctypes.Array, ...]


def build_octave_setup(oct_plan, base, diffusivity: Diffusivity,
                       fixed: bool) -> OctaveSetup:
    """The launch parameters of one octave, computed afresh."""
    specs = octave_specs(oct_plan, base)
    S, h, w = len(specs), oct_plan.height, oct_plan.width
    reach = max(max(sp.step, sp.smooth_radius) for sp in specs)
    if min(h, w) <= reach:
        raise ValueError(f"plane {h}x{w} smaller than the stencil reach "
                         f"{reach}")
    diffusivity = Diffusivity(diffusivity)
    if routes_resident(oct_plan, base):
        p = np.zeros(8 + 4 * MAX_SCALES + MAX_SCALES * (MAX_RADIUS + 1),
                     np.int32)
        p[:8] = (int(fixed), h, w, S, int(diffusivity), int(bool(base)),
                 octave_reach(oct_plan, base),
                 sum(len(sp.taus) for sp in specs))
        off = 0
        facs = []
        kern = p[8 + 4 * MAX_SCALES:].reshape(MAX_SCALES, MAX_RADIUS + 1)
        for s, sp in enumerate(specs):
            p[8 + s] = sp.step
            p[8 + MAX_SCALES + s] = len(sp.taus)
            p[8 + 2 * MAX_SCALES + s] = off
            p[8 + 3 * MAX_SCALES + s] = sp.smooth_radius
            taps = _bits(_taps(sp.smooth_var, sp.smooth_radius, fixed), fixed)
            kern[s, :len(taps)] = taps
            facs += _factors(sp.taus, fixed)
            off += len(sp.taus)
        factors = torch.tensor(facs or [0], dtype=torch.int32 if fixed
                               else torch.float32)
        return OctaveSetup(True, (S, h, w), p, p.ctypes.data, factors, {},
                           (), ())
    for sp in specs:
        if not fused_supported(h, w, sp.taus, sp.step, sp.smooth_radius):
            raise ValueError(
                f"plane {h}x{w}: too small for the tiled kernel's halo "
                f"{halo_for(sp.step, len(sp.taus), sp.smooth_radius)} and "
                f"too large for the resident kernel")
    hw = h * w
    tiled = tuple(tiled_launches(h, w, sp, diffusivity, fixed) for sp in specs)
    # sublevel 0 reads the octave's contiguous input (and smooth), later
    # ones the previous sublevel's L in the stack
    strides = tuple(_strides(hw if s == 0 else S * hw, hw, 0, S * hw, S * hw)
                    for s in range(S))
    return OctaveSetup(False, (S, h, w), None, 0, None, {}, tiled, strides)


_SETUPS: dict = {}


def octave_setup(oct_plan, base, diffusivity: Diffusivity,
                 fixed: bool) -> OctaveSetup:
    """``build_octave_setup``, cached per (octave plan, base, diffusivity,
    flavour).  Keyed by the plan object's identity, which the cache keeps
    alive, so a lookup costs no hashing of the plan."""
    key = (id(oct_plan), base, diffusivity, fixed)
    hit = _SETUPS.get(key)
    if hit is None or hit[0] is not oct_plan:
        if len(_SETUPS) > 256:
            _SETUPS.clear()
        hit = (oct_plan, build_octave_setup(oct_plan, base, diffusivity,
                                            fixed))
        _SETUPS[key] = hit
    return hit[1]


# --------------------------------------------------------------------------
# launches
# --------------------------------------------------------------------------

def _on_device(fn, src, *args):
    """``fn(src, *args)`` with ``src``'s device current, as the C launches
    assume."""
    if src.device.index == torch.cuda.current_device():
        return fn(src, *args)
    with torch.cuda.device(src.device):
        return fn(src, *args)


def _run_tiled(lib, launches, strides, src, smooth, ikc, L, det, lx, ly, B,
               stream, scratch):
    """One sublevel's tiled launches.  Pointers are ints (None for none);
    ``strides``: batch strides (src, smooth, -, L, det/lx/ly).  A split
    chain's earlier launches write L into the two ``scratch()`` planes."""
    if len(launches) == 1:
        err = lib.akaze_sublevel(launches[0].ptr, ctypes.addressof(strides),
                                 src, smooth, None, ikc, L, det, lx, ly, B,
                                 stream)
        _build.check(err, "tiled_kernel")
        sublevel.launches += 1
        return
    bufs = scratch()
    hw = bufs.stride(1)
    L_in = None
    for i, lp in enumerate(launches):
        last = i == len(launches) - 1
        dst = L if last else bufs[i % 2].data_ptr()
        st = _strides(strides[0], strides[1], hw,
                      strides[3] if last else hw, strides[4])
        err = lib.akaze_sublevel(lp.ptr, ctypes.addressof(st), src, smooth,
                                 L_in, ikc, dst, det, lx, ly, B, stream)
        _build.check(err, "tiled_kernel")
        sublevel.launches += 1
        L_in = dst


def _launch_sublevel(src, ikc, spec, smooth, diffusivity, fixed):
    b, h, w = src.shape
    if not fused_supported(h, w, spec.taus, spec.step, spec.smooth_radius):
        raise ValueError(f"plane {h}x{w} too small for halo "
                         f"{halo_for(spec.step, len(spec.taus), spec.smooth_radius)}; "
                         f"guard calls with fused_supported()")
    launches = tiled_launches(h, w, spec, diffusivity, fixed)
    out = torch.empty((4, b, h, w), dtype=src.dtype, device=src.device)
    hw = h * w
    ptrs = [out.data_ptr() + 4 * k * b * hw for k in range(4)]
    _run_tiled(_build.library(), launches, _strides(hw, hw, 0, hw, hw),
               src.data_ptr(), _build.ptr(smooth) or None, ikc.data_ptr(),
               *ptrs, b, _build.stream_of(src),
               lambda: torch.empty((2, b, h, w), dtype=src.dtype,
                                   device=src.device))
    return tuple(out.unbind(0))


def _launch_octave(src, ikc, oct_plan, smooth, base, diffusivity, fixed):
    setup = octave_setup(oct_plan, base, diffusivity, fixed)
    S, h, w = setup.shape
    b = src.shape[0]
    if tuple(src.shape[1:]) != (h, w):
        raise ValueError(f"src is {tuple(src.shape)}, the octave plan "
                         f"{h}x{w}")
    dev = src.device
    out = torch.empty((4, b, S, h, w), dtype=src.dtype, device=dev)
    lib = _build.library()
    stream = _build.stream_of(src)
    hw = h * w
    base_ptr = out.data_ptr()
    smooth_ptr = _build.ptr(smooth) or None
    if setup.resident:
        factors = setup.device_factors.get(dev)
        if factors is None:
            factors = setup.device_factors[dev] = setup.factors.to(dev)
        err = lib.akaze_octave(setup.params_ptr, src.data_ptr(), hw,
                               smooth_ptr, hw, ikc.data_ptr(),
                               factors.data_ptr(), base_ptr, b,
                               RESIDENT_CLUSTER, stream)
        _build.check(err, "octave_kernel")
        octave.launches += 1
        return tuple(out.unbind(0))
    plane = 4 * b * S * hw              # bytes between L, det, Lx and Ly
    prev = src.data_ptr()
    for s in range(S):
        L = base_ptr + 4 * s * hw
        _run_tiled(lib, setup.tiled[s], setup.strides[s], prev,
                   smooth_ptr if s == 0 else None, ikc.data_ptr(), L,
                   L + plane, L + 2 * plane, L + 3 * plane, b, stream,
                   lambda: torch.empty((2, b, h, w), dtype=src.dtype,
                                       device=dev))
        prev = L
    return tuple(out.unbind(0))


def _check_inputs(src, ikc, smooth, fixed):
    if src.dim() != 3:
        raise ValueError(f"src must be [B, H, W], got {tuple(src.shape)}")
    dev = src.device
    dtype = torch.int32 if fixed else torch.float32
    _build.check_tensor("src", src, dtype, src.shape, dev)
    _build.check_tensor("ikc", ikc, torch.float32, src.shape[:1], dev)
    if smooth is not None:
        _build.check_tensor("smooth", smooth, dtype, src.shape, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 kernel for device {dev}")
    return dev.type == "cuda"


def sublevel(src: torch.Tensor, ikc: torch.Tensor, taus: Tuple[float, ...],
             step: int, smooth: Optional[torch.Tensor] = None,
             smooth_var: float = 1.0, smooth_radius: int = 2,
             first_sublevel: bool = False,
             diffusivity: Diffusivity = Diffusivity.PM_G2,
             fixed: bool = False):
    """One scale-space sublevel for a batch of images, on the tiled kernel.

    Args:
      src: [B, H, W] float32 (int32 when ``fixed``), the previous
        sublevel's L (or the decimated image of an octave start, or the
        input image for the first sublevel).
      ikc: [B] float32, 1 / kcontrast^2 per image.
      taus: FED step sizes.
      step: sigma_size, the stride of the derivative stencils.
      smooth: optional [B, H, W] sigma-1 smooth of ``src``'s type (octave
        starts get it from ``down_with_smooth``); otherwise a Gaussian of
        (``smooth_var``, ``smooth_radius``) is taken of ``src``.
      first_sublevel: L = the smooth (the base lowpass, akaze.cpp:325-332).
      fixed: the 16.16 fixed-point flavour; must agree with ``src.dtype``.

    Returns (L, det, lx, ly), each [B, H, W] of ``src``'s type.
    """
    on_card = _check_inputs(src, ikc, smooth, fixed)
    spec = SublevelSpec(tuple(taus), int(step), smooth_var, smooth_radius,
                        bool(first_sublevel))
    diffusivity = Diffusivity(diffusivity)
    if not on_card:
        return sublevel_plain(src, ikc, *spec[:2], smooth, *spec[2:],
                              diffusivity=diffusivity, fixed=bool(fixed))
    return _on_device(_launch_sublevel, src, ikc, spec, smooth, diffusivity,
                      bool(fixed))


def octave(src: torch.Tensor, ikc: torch.Tensor, oct_plan,
           smooth: Optional[torch.Tensor] = None, base=None,
           diffusivity: Diffusivity = Diffusivity.PM_G2,
           fixed: bool = False):
    """Every sublevel of one octave for a batch of images.

    Args:
      src: [B, H, W] float32 (int32 when ``fixed``), contiguous: the input
        image (first octave) or the decimated last L of the octave before.
      ikc: [B] float32, 1 / kcontrast^2 per image.
      oct_plan: the octave's ``plan.OctavePlan``.
      smooth: the decimation's sigma-1 smooth of ``src`` (octaves after the
        first), or None.
      base: (variance, radius) of the first octave's base smooth, or None.
      fixed: the 16.16 fixed-point flavour; must agree with ``src.dtype``.

    Returns (L, det, lx, ly), each [B, S, H, W] of ``src``'s type: four
    views of one [4, B, S, H, W] tensor.  On a CUDA tensor the octave runs
    on the resident kernel when ``routes_resident``, else one tiled launch
    per sublevel (more for a split chain).
    """
    on_card = _check_inputs(src, ikc, smooth, fixed)
    diffusivity = Diffusivity(diffusivity)
    base = None if base is None else (float(base[0]), int(base[1]))
    if not on_card:
        return octave_plain(src, ikc, oct_plan, smooth, base, diffusivity,
                            bool(fixed))
    return _on_device(_launch_octave, src, ikc, oct_plan, smooth, base,
                      diffusivity, bool(fixed))


# kernel launches; a replayed program adds the launches its capture
# recorded (programs.py), so the count covers graphs too
sublevel.launches = 0
octave.launches = 0


def launches() -> int:
    """K1 launches of both kernels since their counters were last reset."""
    return sublevel.launches + octave.launches

