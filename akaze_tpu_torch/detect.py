"""Keypoint detection: scale-space extrema, NMS, selection, refinement.

Port of the float path of ``akaze_tpu/detect.py`` in plain PyTorch.
Reference kernels: gCalcExtremaMap (akazed.cu:1334-1393), gNmsRNaive
(akazed.cu:1554-1613), gRefine (akazed.cu:1615-1662).

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

from typing import List, NamedTuple

import torch

from .plan import PipelinePlan
from .scale_space import OctaveData

FMIN_VAL = -1.0e6          # akazed.cu:12

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
    response: torch.Tensor  # [max_pts] float32
    valid: torch.Tensor     # [max_pts] bool
    count: torch.Tensor     # scalar int32
    overflow: torch.Tensor  # scalar bool: NMS survivors were dropped


def pow2(o: torch.Tensor) -> torch.Tensor:
    """2 ** o as float32 for an integer tensor ``o`` (octave ratios)."""
    return torch.bitwise_left_shift(torch.ones_like(o), o).to(torch.float32)


def _pad_const(x, pad_y: int, pad_x: int, value):
    h, w = x.shape[-2:]
    out = x.new_full(x.shape[:-2] + (h + 2 * pad_y, w + 2 * pad_x), value)
    out[..., pad_y:pad_y + h, pad_x:pad_x + w] = x
    return out


def _extrema_candidates(det: torch.Tensor, oct_plan, threshold: float):
    """Per-scale 3x3 strict maxima above threshold inside the border rect.

    det: [S, H, W].  Returns resp [S, H, W], FMIN_VAL where not a
    candidate."""
    s, h, w = det.shape
    pad = _pad_const(det, 1, 1, FMIN_VAL)
    c = pad[:, 1:1 + h, 1:1 + w]
    is_max = c > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            is_max &= c > pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    dev = det.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]

    def bound(attr):
        return torch.tensor([getattr(sp, attr) for sp in oct_plan.scales],
                            device=dev)[:, None, None]

    rect = ((rows >= bound("y_lo")) & (rows <= bound("y_hi"))
            & (cols >= bound("x_lo")) & (cols <= bound("x_hi")))
    return torch.where(is_max & rect, c, torch.full_like(c, FMIN_VAL))


def build_extrema_maps(octaves: List[OctaveData], plan: PipelinePlan):
    """Full-resolution response/size/layer maps (akaze.cpp:249-258 init +
    gCalcExtremaMap per octave).  ``octaves`` hold one image's [S, H, W]
    planes."""
    cfg = plan.config
    h0, w0 = plan.height, plan.width
    dev = octaves[0].det.device
    threshold = cfg.dthreshold
    resp_full = torch.full((h0, w0), FMIN_VAL, device=dev)
    size_full = torch.zeros((h0, w0), device=dev)
    layer_full = torch.full((h0, w0), -1, dtype=torch.int32, device=dev)

    for oi, (odata, oplan) in enumerate(zip(octaves, plan.octaves)):
        resp = _extrema_candidates(odata.det, oplan, threshold)
        _, h, w = resp.shape
        # deterministic cross-scale winner: the lowest scale on ties
        best_s = torch.argmax(resp, dim=0)
        best = torch.gather(resp, 0, best_s[None])[0]
        sizes = torch.tensor([sp.size for sp in oplan.scales],
                             dtype=torch.float32, device=dev)
        best_size = sizes[best_s]
        best_layer = (oi * cfg.max_scale + best_s).to(torch.int32)

        # strided write-back: octave pixel (y, x) sits at (y, x) * 2**oi
        r = 1 << oi

        def up(v, fill):
            out = v.new_full((h0, w0), fill)
            out[:h * r:r, :w * r:r] = v
            return out

        up_resp = up(best, FMIN_VAL)
        take = up_resp > resp_full   # strictly greater: earlier octaves win
        resp_full = torch.where(take, up_resp, resp_full)
        size_full = torch.where(take, up(best_size, 0.0), size_full)
        layer_full = torch.where(take & (up_resp > threshold),
                                 up(best_layer, -1), layer_full)
    return resp_full, size_full, layer_full


def nms(resp_full, size_full, layer_full, plan: PipelinePlan):
    """Circular radius-R NMS (gNmsRNaive, akazed.cu:1554-1613).

    A candidate survives unless a neighbour inside the circle
    i^2 + j^2 < size^2 has a strictly larger response, or an equal one in
    the top-left quadrant (i <= 0 and j <= 0), the reference tie-break
    (akazed.cu:1586-1588).  Returns the survivor mask [H, W].
    """
    h, w = resp_full.shape
    psz = plan.psz
    rmax = plan.max_nms_radius
    # int sqsz = fsz * fsz truncates (akazed.cu:1571)
    sqsz = (size_full * size_full).to(torch.int32)
    pad = _pad_const(resp_full, rmax, rmax, FMIN_VAL)
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
    rows = torch.arange(h, device=resp_full.device)[:, None]
    cols = torch.arange(w, device=resp_full.device)[None, :]
    # launch covers ix >= psz with the guard ix + psz < width
    # (akazed.cu:1558-1563)
    region = ((cols >= psz) & (cols + psz < w)
              & (rows >= psz) & (rows + psz < h))
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
    count = torch.minimum(torch.minimum(total, n_cand),
                          torch.tensor(max_pts, dtype=torch.int32,
                                       device=dev))
    overflow = (total > n_cand) | (total > max_pts)
    valid = torch.arange(max_pts, device=dev) < count
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    layer = layer_full.reshape(-1)[idx]
    table = torch.tensor((0.0,) + tuple(size_table), dtype=torch.float32,
                         device=dev)
    size = table[(layer + 1).clamp(0, len(size_table))]
    return Keypoints(
        x=(idx % w).to(torch.float32), y=(idx // w).to(torch.float32),
        size=size, layer=layer, response=resp_full.reshape(-1)[idx],
        valid=valid, count=count, overflow=overflow)


def refine_keypoints(kps: Keypoints, octaves: List[OctaveData],
                     plan: PipelinePlan) -> Keypoints:
    """Sub-pixel refinement (gRefine, akazed.cu:1615-1662): 3x3 quadratic
    fit on the det plane; offsets outside (-1, 1) keep the integer
    location."""
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
        return torch.tensor(v, dtype=torch.int64, device=dev)

    layer = kps.layer.to(torch.int64)
    o = torch.div(layer, ms, rounding_mode="floor").clamp(min=0)
    s = layer - torch.div(layer, ms, rounding_mode="floor") * ms
    wo = table(widths)[o]
    base = table(offs)[o] + s * table(planes)[o]
    xo = kps.x.to(torch.int64) >> o
    yo = kps.y.to(torch.int64) >> o
    idx = base + yo * wo + xo

    def g(off):
        return det[(idx + off).clamp(0, total - 1)]

    c = g(0)
    m0, m2 = g(-1), g(1)
    t0, t1, t2 = g(-wo - 1), g(-wo), g(-wo + 1)
    b0, b1, b2 = g(wo - 1), g(wo), g(wo + 1)
    v2 = c + c
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


def detect_keypoints(octaves: List[OctaveData],
                     plan: PipelinePlan) -> Keypoints:
    """Full detection stage of one image: extrema maps -> NMS -> selection
    -> refinement.  ``octaves`` hold [S, H, W] planes."""
    resp, size, layer = build_extrema_maps(octaves, plan)
    mask = nms(resp, size, layer, plan)
    kps = select_keypoints(mask, resp, layer, plan.config.max_pts,
                           size_table_for(plan))
    return refine_keypoints(kps, octaves, plan)


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
    ``dtype``, with Hp, Wp at least ``wsize``."""
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
            dst[i:i + s, :h, :w] = src
        ws += [w] * s
        hs += [h] * s
        i += s
    return PaddedPyramid(
        L=out[0], lx=out[1], ly=out[2],
        widths=torch.tensor(ws, dtype=torch.int32, device=dev),
        heights=torch.tensor(hs, dtype=torch.int32, device=dev))
