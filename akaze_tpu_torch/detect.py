"""Keypoint detection: scale-space extrema, NMS, selection, refinement.

Port of ``akaze_tpu/detect.py`` in plain PyTorch.  Reference kernels:
gCalcExtremaMap (akazed.cu:1334-1393), gNmsRNaive (akazed.cu:1554-1613),
gRefine (akazed.cu:1615-1662); fixed-point variants at akazed.cu:3476-3646.

The path follows the det planes' type: float32, or int32 on the 16.16
fixed-point path, whose response maps, threshold (``idthreshold``) and
refinement arithmetic are integers.

  * The reference's benign race on the full-resolution response maps
    (akazed.cu:1364) is a deterministic scale argmax (lowest scale on ties)
    followed by a strictly-greater merge across octaves.
  * Atomic keypoint emission (atomicInc, akazed.cu:1603) is a prefix-sum
    compaction into fixed-capacity tensors: slots hold the valid keypoints
    as a prefix, in row-major order, which the descriptor and matcher rely
    on.  The caps are semantics: at most TILE_CAP survivors per TILE-column
    span of a row, ROW_CAP per row, and the first ``max_pts`` overall; any
    drop sets ``overflow``.  The JAX package implements the same pick with
    TPU formulations (an MXU bitpack, a top_k, a sort); here it is two
    cumulative sums.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple

import torch

from .plan import PipelinePlan
from .scale_space import OctaveData

FMIN_VAL = -1.0e6          # akazed.cu:12
IMIN_VAL = -(1 << 30)      # stand-in for the int map init (akaze.cpp:523)

ROW_CAP = 32    # max keypoints kept per image row
TILE = 64       # column-span width of the per-span cap
TILE_CAP = 12   # max survivors kept per TILE-column span of a row


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint tensors (replaces the AoS AkazePoint buffer,
    akaze_structures.h:19-40)."""
    x: torch.Tensor         # [max_pts] float32, full-resolution coords
    y: torch.Tensor         # [max_pts] float32
    size: torch.Tensor      # [max_pts] float32 (octave-local sigma size)
    layer: torch.Tensor     # [max_pts] int32: octave * max_scale + scale
    response: torch.Tensor  # [max_pts] float32 (the fixed path's ints too)
    valid: torch.Tensor     # [max_pts] bool
    count: torch.Tensor     # scalar int32
    overflow: torch.Tensor  # scalar bool: NMS survivors were dropped


def pow2(o: torch.Tensor) -> torch.Tensor:
    """2 ** o as float32 for an integer tensor ``o`` (octave ratios)."""
    return torch.bitwise_left_shift(torch.ones_like(o), o).to(torch.float32)


@lru_cache(maxsize=None)
def const_table(values: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """A constant table on ``device``, built once per (values, type,
    device).  Copying a host list to the card blocks the stream, so the
    per-plan tables of a pair iteration are copied once and reused; callers
    must not write into the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def _pad_const(x, pad_y: int, pad_x: int, value):
    h, w = x.shape[-2:]
    out = x.new_full(x.shape[:-2] + (h + 2 * pad_y, w + 2 * pad_x), value)
    out[..., pad_y:pad_y + h, pad_x:pad_x + w] = x
    return out


def _minval(x: torch.Tensor):
    """The 'no response' fill of a response map of ``x``'s type."""
    return IMIN_VAL if x.dtype == torch.int32 else FMIN_VAL


def _extrema_candidates(det: torch.Tensor, oct_plan, threshold,
                        det_pad=None, row0: int = 0):
    """Per-scale 3x3 strict maxima above threshold inside the border rect.

    det: [S, H, W].  Returns resp [S, H, W], the min fill where not a
    candidate.  ``det_pad``/``row0`` serve the row-sharded tier
    (parallel/spatial.py): a [S, H + 2, W] det stack whose extra rows are
    the neighbours' ghost rows (the min fill at the global edges), and the
    shard's global row offset for the border rectangle."""
    s, h, w = det.shape
    minval = _minval(det)
    pad = (_pad_const(det, 1, 1, minval) if det_pad is None
           else _pad_const(det_pad, 0, 1, minval))
    c = pad[:, 1:1 + h, 1:1 + w]
    is_max = c > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            is_max &= c > pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    dev = det.device
    rows = torch.arange(row0, row0 + h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]

    def bound(attr):
        return const_table(tuple(getattr(sp, attr) for sp in oct_plan.scales),
                           torch.int64, dev)[:, None, None]

    rect = ((rows >= bound("y_lo")) & (rows <= bound("y_hi"))
            & (cols >= bound("x_lo")) & (cols <= bound("x_hi")))
    return torch.where(is_max & rect, c, torch.full_like(c, minval))


def build_extrema_maps(octaves: List[OctaveData], plan: PipelinePlan,
                       det_pads=None, row0: int = 0):
    """Full-resolution response/size/layer maps (akaze.cpp:249-258 init +
    gCalcExtremaMap per octave).  ``octaves`` hold one image's [S, H, W]
    planes; int32 det planes (the fixed path) give int32 responses,
    thresholded at ``idthreshold``.

    With ``det_pads``/``row0`` (the row-sharded tier) the maps cover only
    this shard's rows: ``det_pads`` holds each octave's det stack with one
    ghost row on each side, and ``row0`` is the shard's full-resolution
    row offset (its octave-o offset ``row0 >> o`` is exact, since the
    tier keeps per-octave local row counts even)."""
    cfg = plan.config
    w0 = plan.width
    h0 = octaves[0].det.shape[-2] if det_pads is not None else plan.height
    det0 = octaves[0].det
    dev = det0.device
    fixed = det0.dtype == torch.int32
    threshold = cfg.idthreshold if fixed else cfg.dthreshold
    minval = _minval(det0)
    resp_full = torch.full((h0, w0), minval, dtype=det0.dtype, device=dev)
    size_full = torch.zeros((h0, w0), device=dev)
    layer_full = torch.full((h0, w0), -1, dtype=torch.int32, device=dev)

    for oi, (odata, oplan) in enumerate(zip(octaves, plan.octaves)):
        resp = _extrema_candidates(
            odata.det, oplan, threshold,
            None if det_pads is None else det_pads[oi], row0 >> oi)
        _, h, w = resp.shape
        # deterministic cross-scale winner: the lowest scale on ties
        best_s = torch.argmax(resp, dim=0)
        best = torch.gather(resp, 0, best_s[None])[0]
        sizes = const_table(tuple(sp.size for sp in oplan.scales),
                            torch.float32, dev)
        best_size = sizes[best_s]
        best_layer = (oi * cfg.max_scale + best_s).to(torch.int32)

        # strided write-back: octave pixel (y, x) sits at (y, x) * 2**oi
        r = 1 << oi

        def up(v, fill):
            out = v.new_full((h0, w0), fill)
            out[:h * r:r, :w * r:r] = v
            return out

        up_resp = up(best, minval)
        take = up_resp > resp_full   # strictly greater: earlier octaves win
        resp_full = torch.where(take, up_resp, resp_full)
        size_full = torch.where(take, up(best_size, 0.0), size_full)
        layer_full = torch.where(take & (up_resp > threshold),
                                 up(best_layer, -1), layer_full)
    return resp_full, size_full, layer_full


def nms(resp_full, size_full, layer_full, plan: PipelinePlan,
        resp_pad=None, row0: int = 0, h_global=None):
    """Circular radius-R NMS (gNmsRNaive, akazed.cu:1554-1613).

    A candidate survives unless a neighbour inside the circle
    i^2 + j^2 < size^2 has a strictly larger response, or an equal one in
    the top-left quadrant (i <= 0 and j <= 0), the reference tie-break
    (akazed.cu:1586-1588).  Returns the survivor mask [H, W].

    Row-sharded tier: ``resp_pad`` is [H + 2*rmax, W] with the
    neighbours' ghost rows (the min fill at the global edges);
    ``row0``/``h_global`` globalise the border region.
    """
    h, w = resp_full.shape
    psz = plan.psz
    rmax = plan.max_nms_radius
    # int sqsz = fsz * fsz truncates (akazed.cu:1571)
    sqsz = (size_full * size_full).to(torch.int32)
    pad = (_pad_const(resp_full, rmax, rmax, _minval(resp_full))
           if resp_pad is None
           else _pad_const(resp_pad, 0, rmax, _minval(resp_full)))
    suppressed = torch.zeros((h, w), dtype=torch.bool,
                             device=resp_full.device)
    for i in range(-rmax, rmax + 1):
        for j in range(-rmax, rmax + 1):
            if i == 0 and j == 0:
                continue
            nresp = pad[rmax + i:rmax + i + h, rmax + j:rmax + j + w]
            beats = nresp > resp_full
            if i <= 0 and j <= 0:
                beats |= nresp == resp_full
            suppressed |= (i * i + j * j < sqsz) & beats
    rows = torch.arange(row0, row0 + h, device=resp_full.device)[:, None]
    cols = torch.arange(w, device=resp_full.device)[None, :]
    hg = h if h_global is None else h_global
    # launch covers ix >= psz with the guard ix + psz < width
    # (akazed.cu:1558-1563)
    region = ((cols >= psz) & (cols + psz < w)
              & (rows >= psz) & (rows + psz < hg))
    return (layer_full >= 0) & region & ~suppressed


def size_table_for(plan: PipelinePlan) -> tuple:
    """Per-layer-code sigma size (what build_extrema_maps writes into
    size_full)."""
    ms = plan.config.max_scale
    table = [0.0] * (len(plan.octaves) * ms)
    for oi, oplan in enumerate(plan.octaves):
        for si, sp in enumerate(oplan.scales):
            table[oi * ms + si] = float(sp.size)
    return tuple(table)


def select_keypoints(mask, resp_full, layer_full, max_pts: int,
                     size_table: tuple) -> Keypoints:
    """Compaction of the NMS survivors into fixed-capacity tensors.

    Keeps the leftmost TILE_CAP survivors of every TILE-column span of a
    row, then the leftmost ROW_CAP of each row, then the first ``max_pts``
    in row-major order.  Dead slots point at pixel 0, as in the JAX
    package.  Prefix sums, not atomics: no host synchronisation and no
    order that changes from run to run.
    """
    h, w = mask.shape
    dev = mask.device
    wt = -(-w // TILE) * TILE
    ntiles = wt // TILE
    cap = min(ROW_CAP, w, ntiles * TILE_CAP)
    npick = min(TILE_CAP, cap)
    m = torch.zeros((h, wt), dtype=torch.int32, device=dev)
    m[:, :w] = mask.to(torch.int32)
    in_tile = m.view(h, ntiles, TILE).cumsum(-1).view(h, wt)
    keep = (m > 0) & (in_tile <= npick)
    keep = (keep & (keep.to(torch.int32).cumsum(-1) <= cap))[:, :w]
    flat = keep.reshape(-1)
    pos = flat.to(torch.int64).cumsum(0) - 1
    n_cand = flat.sum(dtype=torch.int32)
    slot = torch.where(flat & (pos < max_pts), pos,
                       torch.full_like(pos, max_pts))
    idx = torch.zeros(max_pts + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(h * w, device=dev))
    idx = idx[:max_pts]

    total = mask.sum(dtype=torch.int32)
    count = torch.minimum(total, n_cand).clamp(max=max_pts)
    overflow = (total > n_cand) | (total > max_pts)
    valid = torch.arange(max_pts, device=dev) < count
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    layer = layer_full.reshape(-1)[idx]
    table = const_table((0.0,) + tuple(size_table), torch.float32, dev)
    size = table[(layer + 1).clamp(0, len(size_table))]
    return Keypoints(
        x=(idx % w).to(torch.float32), y=(idx // w).to(torch.float32),
        size=size, layer=layer,
        response=resp_full.reshape(-1)[idx].to(torch.float32),
        valid=valid, count=count, overflow=overflow)


def refine_keypoints(kps: Keypoints, octaves: List[OctaveData],
                     plan: PipelinePlan, row_shift=None) -> Keypoints:
    """Sub-pixel refinement (gRefine, akazed.cu:1615-1662): 3x3 quadratic
    fit on the det plane; offsets outside (-1, 1) keep the integer
    location.  On int32 det planes the differences are taken in int32 with
    arithmetic shifts and wrap as the JAX package's (and CUDA's) int does
    (akazed.cu:3621-3627).

    Row-sharded tier: ``row_shift`` (one int per octave) maps a keypoint's
    global octave row to its row in this shard's det stacks (the shard's
    offset minus their one ghost row).  Exact at the seams: the extrema
    border keeps every keypoint at least one row inside the image at its
    own octave, so the 3x3 fit never reads a fill row."""
    ms = plan.config.max_scale
    dev = kps.x.device
    det = torch.cat([o.det.reshape(-1) for o in octaves])
    offs, widths, planes = [], [], []
    total = 0
    for o in octaves:
        s, h, w = o.det.shape
        offs.append(total)
        widths.append(w)
        planes.append(h * w)
        total += s * h * w

    def table(v):
        return const_table(tuple(v), torch.int64, dev)

    layer = kps.layer.to(torch.int64)
    o = torch.div(layer, ms, rounding_mode="floor").clamp(min=0)
    s = layer - torch.div(layer, ms, rounding_mode="floor") * ms
    wo = table(widths)[o]
    base = table(offs)[o] + s * table(planes)[o]
    xo = kps.x.to(torch.int64) >> o
    yo = kps.y.to(torch.int64) >> o
    # the gather uses the shard's rows; the refined y stays global (yo)
    yo_idx = yo if row_shift is None else yo - table(row_shift)[o]
    idx = base + yo_idx * wo + xo

    def g(off):
        return det[(idx + off).clamp(0, total - 1)]

    c = g(0)
    m0, m2 = g(-1), g(1)
    t0, t1, t2 = g(-wo - 1), g(-wo), g(-wo + 1)
    b0, b1, b2 = g(wo - 1), g(wo), g(wo + 1)
    v2 = c + c
    if det.dtype == torch.int32:
        dx = (m2 - m0) >> 1
        dy = (b1 - t1) >> 1
        dxx = m2 + m0 - v2
        dyy = b1 + t1 - v2
        dxy = (b2 + t0 - t2 - b0) >> 2
        dd = (dxx * dyy - dxy * dxy).to(torch.float32)
        dxf, dyf, dxxf, dyyf, dxyf = (v.to(torch.float32)
                                      for v in (dx, dy, dxx, dyy, dxy))
    else:
        dxf = 0.5 * (m2 - m0)
        dyf = 0.5 * (b1 - t1)
        dxxf = m2 + m0 - v2
        dyyf = b1 + t1 - v2
        dxyf = 0.25 * (b2 + t0 - t2 - b0)
        dd = dxxf * dyyf - dxyf * dxyf
    nz = dd != 0.0
    idd = torch.where(nz, torch.ones_like(dd) / torch.where(nz, dd, 1.0),
                      torch.zeros_like(dd))
    dst0 = idd * (dxyf * dyf - dyyf * dxf)
    dst1 = idd * (dxyf * dxf - dxxf * dyf)
    weak = (dst0 < -1.0) | (dst0 > 1.0) | (dst1 < -1.0) | (dst1 > 1.0)
    ratio = pow2(o)
    new_x = ratio * (xo.to(torch.float32) + dst0)
    new_y = ratio * (yo.to(torch.float32) + dst1)
    keep = weak | ~kps.valid
    return kps._replace(x=torch.where(keep, kps.x, new_x),
                        y=torch.where(keep, kps.y, new_y))


def select_and_refine(mask, resp_full, layer_full,
                      octaves: List[OctaveData],
                      plan: PipelinePlan) -> Keypoints:
    """Keypoints of one image from its NMS survivors and full-resolution
    maps: selection -> refinement.  ``octaves`` hold [S, H, W] planes."""
    kps = select_keypoints(mask, resp_full, layer_full, plan.config.max_pts,
                           size_table_for(plan))
    return refine_keypoints(kps, octaves, plan)


def detect_keypoints(octaves: List[OctaveData],
                     plan: PipelinePlan) -> Keypoints:
    """Full detection stage of one image in plain PyTorch: extrema maps ->
    NMS -> selection -> refinement.  ``octaves`` hold [S, H, W] planes.
    The pipeline runs the first two stages of a whole batch in one kernel
    instead (``ops/detect.py``)."""
    resp, size, layer = build_extrema_maps(octaves, plan)
    mask = nms(resp, size, layer, plan)
    return select_and_refine(mask, resp, layer, octaves, plan)


class PaddedPyramid(NamedTuple):
    """All sublevel planes zero-padded to a common [P, Hp, Wp] stack.

    Plane index == the keypoint's layer code (octave * max_scale + scale),
    plus ``image * planes_per_image`` when several images are stacked."""
    L: torch.Tensor       # [P, Hp, Wp]
    lx: torch.Tensor
    ly: torch.Tensor
    widths: torch.Tensor   # [P] int32: true octave width of each plane
    heights: torch.Tensor  # [P] int32


def build_padded_pyramid(octaves: List[OctaveData], wsize: int,
                         dtype=torch.bfloat16) -> PaddedPyramid:
    """Stack every [S, H, W] plane of ``octaves`` (one or more images'
    octave lists, concatenated) into zero-padded [P, Hp, Wp] planes of
    ``dtype``, with Hp, Wp at least ``wsize``.  Planes go through float32
    first: int32 -> float32 is exact for the fixed path's values, so a
    bf16 stack rounds once, from float32, as the JAX package's does."""
    h0, w0 = octaves[0].det.shape[-2:]
    hp, wp = max(h0, wsize), max(w0, wsize)
    p = sum(o.det.shape[0] for o in octaves)
    dev = octaves[0].det.device
    out = [torch.zeros((p, hp, wp), dtype=dtype, device=dev)
           for _ in range(3)]
    ws, hs = [], []
    i = 0
    for o in octaves:
        s, h, w = o.det.shape
        for dst, src in zip(out, (o.L, o.lx, o.ly)):
            dst[i:i + s, :h, :w] = src.to(torch.float32)
        ws += [w] * s
        hs += [h] * s
        i += s
    return PaddedPyramid(
        L=out[0], lx=out[1], ly=out[2],
        widths=const_table(tuple(ws), torch.int32, dev),
        heights=const_table(tuple(hs), torch.int32, dev))
