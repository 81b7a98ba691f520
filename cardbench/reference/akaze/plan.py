"""Static scale-space plan.

The reference computes octave layouts, FED step tables, per-scale sizes and
extrema borders on the host, interleaved with kernel launches
(akaze.cpp:204-237 and akaze.cpp:300-439).  All of it is *static* given
(image shape, config): it is computed once here, and the pipeline reads
octave shapes, FED tables and border rectangles from it without any
host<->device round trip.

A copy of ``akaze_tpu/plan.py`` (the port must not import the JAX
package); tests hold every field equal to the JAX plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .config import AkazeConfig
from .fed import fed_tau_by_process_time


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    """Static parameters of one (octave, scale) sublevel."""
    octave: int
    scale: int
    esigma: float          # effective sigma (octave-0 units)
    size: float            # sizes[j] = esigma * derivative_factor / 2**octave
    sigma_size: int        # int(size + 0.5); derivative sampling step
    border: float          # smax * sigma_size (extrema border, octave units)
    taus: Tuple[float, ...]  # FED step sizes to diffuse from previous sublevel
    # inclusive pixel bounds of the extrema search rectangle, replicating the
    # truncation semantics of gCalcExtremaMap (akazed.cu:1346-1353)
    x_lo: int
    x_hi: int
    y_lo: int
    y_hi: int


@dataclasses.dataclass(frozen=True)
class OctavePlan:
    octave: int
    width: int
    height: int
    scales: Tuple[ScalePlan, ...]


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Everything static the pipeline needs for a given (H, W, config)."""
    config: AkazeConfig
    width: int
    height: int
    octaves: Tuple[OctavePlan, ...]
    psz: int               # NMS border (min over octaves of border[0]*2**o,
                           # truncated; akaze.cpp:434, 449)
    max_nms_radius: int    # max int(size + 0.5) over all sublevels
    # per-octave kcontrast decay: kcontrast *= 0.75 at the start of every
    # octave > 0 (akaze.cpp:373)
    kcontrast_decay: float = 0.75


def _extrema_bounds(border: float, width: int, height: int):
    """Inclusive [lo, hi] pixel bounds passing the border check.

    Replicates (akazed.cu:1346-1353):
      left  = trunc(ix - border + 0.5) - 1 >= 0
      right = trunc(ix + border + 0.5) + 1 <= width - 1
    with float32 truncation toward zero.
    """
    b = np.float32(border)

    def lo_ok(i):
        return np.trunc(np.float32(i) - b + np.float32(0.5)) - 1 >= 0

    def hi_ok(i, m):
        return np.trunc(np.float32(i) + b + np.float32(0.5)) + 1 <= m - 1

    # analytic guesses, then fix up by +-2 scan
    x_lo = int(math.floor(border + 0.5)) + 0
    while x_lo > 0 and lo_ok(x_lo - 1):
        x_lo -= 1
    while not lo_ok(x_lo):
        x_lo += 1
    x_hi = int(math.ceil(width - border - 2.5))
    while x_hi + 1 < width and hi_ok(x_hi + 1, width):
        x_hi += 1
    while x_hi >= 0 and not hi_ok(x_hi, width):
        x_hi -= 1
    y_lo = x_lo
    y_hi = int(math.ceil(height - border - 2.5))
    while y_hi + 1 < height and hi_ok(y_hi + 1, height):
        y_hi += 1
    while y_hi >= 0 and not hi_ok(y_hi, height):
        y_hi -= 1
    return x_lo, x_hi, y_lo, y_hi


def build_plan(height: int, width: int, config: AkazeConfig) -> PipelinePlan:
    """Build the static plan, mirroring the control flow of Akazer::detect
    (akaze.cpp:240-439) / Akazer::allocMemory (akaze.cpp:204-237)."""
    # --- octave shapes with the <80px early stop (akaze.cpp:211-223) ---
    shapes = [(width, height)]
    for _ in range(1, config.noctaves):
        w, h = shapes[-1]
        w, h = w >> 1, h >> 1
        if w < 80 or h < 80:
            break
        shapes.append((w, h))
    noctaves = len(shapes)

    smax = config.smax
    soffset = config.soffset
    df = config.derivative_factor
    ms = config.max_scale

    octaves = []
    last_etime = 0.5 * soffset * soffset
    psz = float("inf")
    max_r = 0
    for i in range(noctaves):
        w, h = shapes[i]
        oratio = 1 << i
        scales = []
        for j in range(ms):
            if i == 0 and j == 0:
                esigma = soffset
                size = esigma * df
                taus: Tuple[float, ...] = ()
            else:
                esigma = soffset * (2.0 ** (j / float(ms) + i))
                curr_etime = 0.5 * esigma * esigma
                ttime = curr_etime - last_etime
                taus = tuple(fed_tau_by_process_time(
                    ttime, 1, config.tau_max, config.reordering))
                last_etime = curr_etime
                size = esigma * df / oratio
            sigma_size = int(size + 0.5)
            border = smax * sigma_size
            x_lo, x_hi, y_lo, y_hi = _extrema_bounds(border, w, h)
            scales.append(ScalePlan(
                octave=i, scale=j, esigma=esigma, size=size,
                sigma_size=sigma_size, border=border, taus=taus,
                x_lo=x_lo, x_hi=x_hi, y_lo=y_lo, y_hi=y_hi))
            max_r = max(max_r, sigma_size)
        octaves.append(OctavePlan(octave=i, width=w, height=h,
                                  scales=tuple(scales)))
        # psz = min over octaves of border[scale 0] * 2**octave
        # (akaze.cpp:434); cast to int at the NMS call (akaze.cpp:449)
        psz = min(psz, scales[0].border * oratio)

    return PipelinePlan(config=config, width=width, height=height,
                        octaves=tuple(octaves), psz=int(psz),
                        max_nms_radius=max_r)
