"""Keypoint orientation and MLDB binary descriptor (PyTorch).

Port of ``akaze_tpu/descriptor.py``.  Reference kernels: gCalcOrient
(akazed.cu:1665-1736) and gDescribe2 (akazed.cu:1869-2001; fixed point
akazed.cu:3685-3780), with the comparison-index tables of
setCompareIndices (akazed.cu:65-159).

Kernel K2 (ops/describe.py) computes, per keypoint slot, the orientation
and the 29 x 3 MLDB cell sums straight from the plane stack; here the
per-slot window geometry is prepared, and the cell sums become the 486
comparison bits.  The JAX package's window extraction, one-hot sampling
matmuls and band machinery feed TPU memory and are not ported: the kernel
reads each tap where it lies, under the same window rule.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from .config import DESCRIPTOR_BITS, DESCRIPTOR_WORDS
from .detect import Keypoints, PaddedPyramid, const_table, pow2
from .plan import PipelinePlan

# Window big enough for the worst-case sampling radius:
# descriptor |offset| <= scale * 10 * sqrt(2) + 1.5 <= 58.1 for scale 4
# (sigma_size of the largest sublevel); orientation |offset| <= 5*scale + 1.
WSIZE = 128


# --------------------------------------------------------------------------
# static tables
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _orient_grid():
    """11x11 grid (i, j in [-5, 5]) with the r^2 < 36 disc mask and Gaussian
    weights exp(-r^2 * 0.08) (akazed.cu:1692-1697)."""
    wt = np.zeros((11, 11), np.float32)
    for a in range(11):       # row index -> j (vertical offset)
        for b in range(11):   # col index -> i (horizontal offset)
            j, i = a - 5, b - 5
            r2 = i * i + j * j
            if r2 < 36:
                wt[a, b] = math.exp(-r2 * 0.08)
    return wt


@lru_cache(maxsize=None)
def _descriptor_window(patsize: int):
    """Static window geometry of gDescribe2 (akazed.cu:1910-1954).

    Returns (l, k, membership M [winsize^2, 29]) where M[s, c] = 1 iff sample
    s contributes to cell c (cells: 4 of the 2x2 grid, 9 of 3x3, 16 of 4x4).
    """
    size2 = patsize
    size3 = math.ceil(2.0 * patsize / 3.0)
    size4 = math.ceil(0.5 * patsize)
    winsize = max(3 * size3, 4 * size4)
    n = winsize * winsize
    l = np.zeros(n, np.int32)
    k = np.zeros(n, np.int32)
    M = np.zeros((n, 29), np.float32)
    for s in range(n):
        y = s // winsize
        x = s - winsize * y
        m = max(x, y)
        l[s] = x - size2
        k[s] = y - size2
        if m < 2 * size2:
            x2 = 0 if x < size2 else 1
            y2 = 0 if y < size2 else 1
            M[s, y2 * 2 + x2] = 1.0
        if m < 3 * size3:
            x3 = 0 if x < size3 else (1 if x < 2 * size3 else 2)
            y3 = 0 if y < size3 else (1 if y < 2 * size3 else 2)
            M[s, 4 + y3 * 3 + x3] = 1.0
        if m < 4 * size4:
            x4 = (0 if x < size4 else 1) if x < 2 * size4 else \
                 (2 if x < 3 * size4 else 3)
            y4 = (0 if y < size4 else 1) if y < 2 * size4 else \
                 (2 if y < 3 * size4 else 3)
            M[s, 13 + y4 * 4 + x4] = 1.0
    return l, k, M


@lru_cache(maxsize=None)
def _compare_indices() -> Tuple[np.ndarray, np.ndarray]:
    """The 486 MLDB comparison pairs in emission order (setCompareIndices,
    akazed.cu:65-159).  Entries index the flattened [cell * 3 + channel]
    accumulator layout."""
    i1, i2 = [], []

    def block(cells, chan):
        cl = list(cells)
        for a in range(len(cl)):
            for b in range(a + 1, len(cl)):
                i1.append(3 * cl[a] + chan)
                i2.append(3 * cl[b] + chan)

    for chan in range(3):
        block(range(0, 4), chan)        # 2x2 grid
    for chan in range(3):
        block(range(4, 13), chan)       # 3x3 grid
    for chan in range(3):
        block(range(13, 29), chan)      # 4x4 grid
    assert len(i1) == DESCRIPTOR_BITS
    return np.asarray(i1, np.int32), np.asarray(i2, np.int32)


# --------------------------------------------------------------------------
# per-slot window geometry
# --------------------------------------------------------------------------

def slot_params(kps: Keypoints, pp: PaddedPyramid, plan: PipelinePlan,
                plane_base: int = 0, nplanes: int = None, row_off=None):
    """Window geometry of each keypoint slot, as K2 takes it.

    Each keypoint reads a [WSIZE, WSIZE] window of its own sublevel plane,
    centred on it and clamped to the octave's extent
    (``x0 = clip(int(x/2^o + 0.5) - 64, 0, max(w_o - 128, 0))``,
    descriptor.py:174-182 of the JAX package); a tap outside the window
    reads 0.

    Returns ``iparams`` [N, 8] int32 (plane, y0, x0, oy, ox, iscale, live,
    0) and ``fparams`` [N, 2] float32 (yf, xf): (oy, ox) is the integer
    orientation centre ``(int(x + 0.5) >> o) - x0`` and (yf, xf) the
    sub-pixel centre, both window-local; iscale is ``int(size + 0.5)``.
    ``plane_base``/``nplanes`` place this image's planes in a stack of
    several images.

    ``row_off``: optional per-octave row offset (ints) of the stack's
    planes against global octave rows (the row-sharded tier's
    halo-extended shards, parallel/spatial.py).  It is added in the
    integer domain, to the rounded centres: shifting the float y instead
    could drop mantissa bits and flip a +-0.5 rounding.
    """
    ms = plan.config.max_scale
    if nplanes is None:
        nplanes = pp.L.shape[0]
    layer = kps.layer
    p = layer.clamp(0, nplanes - 1) + plane_base
    o = torch.div(layer, ms, rounding_mode="floor").clamp(min=0)
    iratio = torch.ones_like(kps.x) / pow2(o)
    xs = kps.x * iratio
    ys = kps.y * iratio
    off = (0 if row_off is None
           else const_table(tuple(row_off), torch.int32, layer.device)[o])
    xc = (xs + 0.5).to(torch.int32)
    yc = (ys + 0.5).to(torch.int32) + off
    wo = pp.widths[p]
    ho = pp.heights[p]
    x0 = torch.minimum((xc - WSIZE // 2).clamp(min=0),
                       (wo - WSIZE).clamp(min=0))
    y0 = torch.minimum((yc - WSIZE // 2).clamp(min=0),
                       (ho - WSIZE).clamp(min=0))
    ox = ((kps.x + 0.5).to(torch.int32) >> o) - x0
    oy = ((kps.y + 0.5).to(torch.int32) >> o) + off - y0
    iscale = (kps.size + 0.5).to(torch.int32)
    zero = torch.zeros_like(p)
    iparams = torch.stack([p, y0, x0, oy, ox, iscale,
                           kps.valid.to(torch.int32), zero], dim=1)
    fparams = torch.stack([ys - (y0 - off).to(torch.float32),
                           xs - x0.to(torch.float32)], dim=1)
    return (iparams.to(torch.int32).contiguous(),
            fparams.contiguous())


# --------------------------------------------------------------------------
# comparisons and packing
# --------------------------------------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 486] bool -> [N, 16] int32 words holding the 512-bit little-endian
    descriptor (bit t of the descriptor is bit t % 32 of word t // 32; the
    26 pad bits are zero).  The words carry uint32 bit patterns in int32,
    the 32-bit type PyTorch computes on."""
    n = bits.shape[0]
    b = torch.zeros((n, DESCRIPTOR_WORDS * 32), dtype=torch.int64,
                    device=bits.device)
    b[:, :DESCRIPTOR_BITS] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (b.view(n, DESCRIPTOR_WORDS, 32) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


@lru_cache(maxsize=None)
def _compare_index_tensors(device: torch.device):
    """``_compare_indices`` as int64 tensors on ``device``, copied once."""
    return tuple(torch.as_tensor(i, dtype=torch.int64, device=device)
                 for i in _compare_indices())


def finish_descriptors(acc: torch.Tensor) -> torch.Tensor:
    """Cell sums [N, 87] -> descriptor words [N, 16]: bit t is
    ``acc[i1[t]] > acc[i2[t]]`` (``_finish_descriptors``; a gather and a
    compare, so no matrix product and no TF32)."""
    i1, i2 = _compare_index_tensors(acc.device)
    return pack_bits(acc[:, i1] > acc[:, i2])


def descriptors_to_bytes(words: np.ndarray) -> np.ndarray:
    """Host-side: [N, 16] 32-bit words -> [N, 61] uint8 (OpenCV-compatible
    MLDB layout, little-endian bit order as in gDescribe2 bit packing)."""
    return np.ascontiguousarray(
        np.asarray(words).astype("<u4").view(np.uint8).reshape(-1, 64)[:, :61])


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """[N, 16] int32 words -> numpy uint32 (the JAX package's dtype)."""
    return words.detach().cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------
# orientation + descriptor for several images in one launch
# --------------------------------------------------------------------------

def plane_dtype(plan: PipelinePlan, fixed: bool) -> torch.dtype:
    """Type of the descriptor's plane stack: float32 for the fixed path's
    exact flavour (its integers are exact in float32) and for the float
    path with ``bf16_sampling=False`` (the JAX package's XLA float path,
    pipeline.py:72-77 there), else bfloat16."""
    f32 = (plan.config.fixed_descriptor_exact if fixed
           else not plan.config.bf16_sampling)
    return torch.float32 if f32 else torch.bfloat16


def orient_describe_multi(kps_list: List[Keypoints], pp: PaddedPyramid,
                          plan: PipelinePlan, fixed: bool = False,
                          row_off=None):
    """Orientation and descriptor of several images' keypoints with ONE
    launch of K2 (replaces ``orient_describe_pallas_multi``, banded or
    not: both of the JAX package's window deliveries give these results).

    ``pp`` stacks the images' pyramids along the plane axis, image i's
    planes from ``i * nplanes``, of ``plane_dtype(plan, fixed)``.  On the
    fixed path the configuration picks K2's flavour
    (``AkazeConfig.fixed_descriptor_exact``): exact on float32 planes, or
    the float flavour on bf16 planes.  The float path takes the float
    flavour on the planes it is given.  Dead slots get angle 0 and zero
    words.  ``row_off``: as in ``slot_params`` (one image).  Returns a
    list of (angle [N], words [N, 16] int32) per image.
    """
    from .ops.describe import describe, describe_tables

    nimg = len(kps_list)
    nplanes = pp.L.shape[0] // nimg
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes, row_off=row_off)
              for i, k in enumerate(kps_list)]
    iparams = torch.cat([p[0] for p in params])
    fparams = torch.cat([p[1] for p in params])
    tables = describe_tables(plan.config.descriptor_pattern_size,
                             iparams.device)
    exact = fixed and plan.config.fixed_descriptor_exact
    angle, acc = describe(iparams, fparams, (pp.L, pp.lx, pp.ly), tables,
                          fixed=exact)
    words = finish_descriptors(acc)
    out, off = [], 0
    for k in kps_list:
        n = k.x.shape[0]
        out.append((angle[off:off + n], words[off:off + n]))
        off += n
    return out
