"""K2's plain version: per-keypoint orientation and MLDB cell sums.

A frozen copy of the port's ``describe_plain`` and its tables
(``akaze_tpu_torch/ops/describe.py``), without the kernel's own tables'
use: ``describe`` is the plain version itself.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..descriptor import WSIZE, _descriptor_window, _orient_grid

NCELLS = 29
NBINS = 42      # orientation bins
WINDOW = 7      # bins per orientation window (pi / 3)
TAP_ORDERS = 32  # angle buckets of the kernel's MLDB tap order
LOADS = 14 * 32  # the kernel's MLDB load rounds x lanes (csrc/describe.cu)
H_PI = math.pi / 2.0
BIN_SCALE = 21.0 / math.pi

# atan(z)/z on z in [0, 1] as a degree-9 polynomial in z^2 (the TPU
# kernel's _atan2_poly; max abs error 7.6e-9)
_ATAN_COEFS = (9.9999999814e-01, -3.3333292795e-01, 1.9998532540e-01,
               -1.4264892055e-01, 1.0958362103e-01, -8.4276296054e-02,
               5.8457820666e-02, -3.1750529703e-02, 1.1257624297e-02,
               -1.8775595035e-03)


class DescribeTables(NamedTuple):
    """Static sampling tables of K2 on one device.  ``cells`` is the one
    encoding of cell membership: the plain version gathers by it, and the
    kernel's ``lane_taps`` is derived from it.  ``window`` and
    ``tap_order`` serve only the kernel."""
    orient_w: torch.Tensor   # [121] f32 disc weights (0 outside r^2 < 36)
    lof: torch.Tensor        # [T] f32 tap column offsets l
    kof: torch.Tensor        # [T] f32 tap row offsets k
    cells: torch.Tensor      # [T, 3] int32 cell of the tap per grid, or -1
    lane_taps: torch.Tensor  # [M, 32] int16: step i, lane c: the i-th tap
    #                          of cell c, ascending; padded with T (a zero
    #                          tap), lanes 29-31 all T
    window: torch.Tensor     # [42, 7] int32: bin (b + d) % 42 of window b
    tap_order: torch.Tensor  # [32, LOADS] int16: the taps at the angle of
    #                          bucket q ((q + 0.5) pi / 16), by rotated
    #                          half-row band, then column; padded with T


@lru_cache(maxsize=None)
def describe_tables(patsize: int, device) -> DescribeTables:
    l, k, M = _descriptor_window(patsize)
    ntaps = len(l)
    cells = np.full((ntaps, 3), -1, np.int32)
    for grid, (lo, hi) in enumerate(((0, 4), (4, 13), (13, NCELLS))):
        t, c = np.nonzero(M[:, lo:hi])
        cells[t, grid] = c + lo
    members = cell_members(torch.from_numpy(cells))            # [29, M]
    lane_taps = torch.full((members.shape[1], 32), ntaps, dtype=torch.int16)
    lane_taps[:, :NCELLS] = members.T
    window = (np.arange(NBINS)[:, None] + np.arange(WINDOW)) % NBINS
    tap_order = np.full((TAP_ORDERS, LOADS), ntaps, np.int16)
    for q in range(TAP_ORDERS):
        th = (q + 0.5) * 2 * math.pi / TAP_ORDERS
        ys = k * math.sin(th) + l * math.cos(th)
        xs = k * math.cos(th) - l * math.sin(th)
        tap_order[q, :ntaps] = np.lexsort((xs, np.round(2 * ys)))
    dev = torch.device(device)
    return DescribeTables(
        orient_w=torch.as_tensor(_orient_grid().reshape(-1), device=dev),
        lof=torch.as_tensor(l.astype(np.float32), device=dev),
        kof=torch.as_tensor(k.astype(np.float32), device=dev),
        cells=torch.as_tensor(cells, device=dev),
        lane_taps=lane_taps.to(dev),
        window=torch.as_tensor(window.astype(np.int32), device=dev),
        tap_order=torch.as_tensor(tap_order, device=dev))


def cell_members(cells: torch.Tensor) -> torch.Tensor:
    """[29, M] int64 taps of each cell, ascending (the order in which the
    kernel adds them), padded with T (the index of a zero tap)."""
    ntaps = cells.shape[0]
    cell_ids = torch.arange(NCELLS, device=cells.device)
    hit = (cells[:, :, None] == cell_ids).any(1).T          # [29, T]
    taps = torch.arange(ntaps, device=cells.device).expand(NCELLS, ntaps)
    members = torch.where(hit, taps, ntaps).sort(dim=1).values
    return members[:, :int(hit.sum(1).max())]


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Accurate polynomial atan2 (the TPU kernel's ``_atan2_poly``)."""
    absx, absy = x.abs(), y.abs()
    mx = torch.maximum(absx, absy)
    mn = torch.minimum(absx, absy)
    z = mn / torch.where(mx == 0, torch.ones_like(mx), mx)
    t = z * z
    acc = torch.full_like(z, _ATAN_COEFS[-1])
    for c in _ATAN_COEFS[-2::-1]:
        acc = acc * t + c
    r = acc * z
    r = torch.where(absy > absx, H_PI - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's polynomial atan2 (dFastAtan2, akazed.cu:173-185)."""
    absx, absy = x.abs(), y.abs()
    mx = torch.maximum(absx, absy)
    mn = torch.minimum(absx, absy)
    a = mn / torch.where(mx == 0, torch.ones_like(mx), mx)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = torch.where(absy > absx, H_PI - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def describe_plain(iparams, fparams, planes, tables: DescribeTables,
                   fixed: bool = False):
    """The plain PyTorch version of K2; same arguments and results as
    ``describe``."""
    plane_l, plane_x, plane_y = planes
    _, hp, wp = plane_l.shape
    ip = iparams.to(torch.int64)
    p, y0, x0, oy, ox, isc, live = (ip[:, i] for i in range(7))
    yf, xf = fparams[:, 0], fparams[:, 1]
    live = live > 0
    base = (p * hp + y0) * wp + x0
    dev = iparams.device

    def sample(plane, r, c):
        inside = (r >= 0) & (r < WSIZE) & (c >= 0) & (c < WSIZE)
        idx = (base[:, None] + r.clamp(0, WSIZE - 1) * wp
               + c.clamp(0, WSIZE - 1))
        v = plane.reshape(-1)[idx].to(torch.float32)
        return torch.where(inside, v, torch.zeros_like(v))

    # ---- orientation ----
    t = torch.arange(121, device=dev)
    r = oy[:, None] + isc[:, None] * (t // 11 - 5)
    c = ox[:, None] + isc[:, None] * (t % 11 - 5)
    w = tables.orient_w
    dx = w * sample(plane_x, r, c)
    dy = w * sample(plane_y, r, c)
    tap_angle = (fast_atan2 if fixed else atan2_poly)(dy, dx)
    abin = ((tap_angle * BIN_SCALE).to(torch.int32) + 21).clamp(0, 41)
    bins = torch.arange(42, device=dev, dtype=torch.int32)
    resx = torch.zeros((iparams.shape[0], 42), device=dev)
    resy = torch.zeros_like(resx)
    zero = torch.zeros_like(resx)
    for tap in np.nonzero(_orient_grid().reshape(-1) > 0)[0]:
        hit = abin[:, tap, None] == bins
        resx = resx + torch.where(hit, dx[:, tap, None], zero)
        resy = resy + torch.where(hit, dy[:, tap, None], zero)
    re8x, re8y = resx, resy
    for d in range(1, 7):
        re8x = re8x + torch.roll(resx, -d, 1)
        re8y = re8y + torch.roll(resy, -d, 1)
    first = torch.argmax(re8x * re8x + re8y * re8y, dim=1, keepdim=True)
    angle = fast_atan2(re8y.gather(1, first)[:, 0],
                       re8x.gather(1, first)[:, 0])
    angle = torch.where(angle < 0.0, angle + 2.0 * math.pi, angle)
    angle = torch.where(live, angle, torch.zeros_like(angle))

    # ---- MLDB taps and cell sums ----
    co = torch.cos(angle)[:, None]
    si = torch.sin(angle)[:, None]
    sc = isc.to(torch.float32)[:, None]
    xs = (xf[:, None] + sc * (tables.kof * co - tables.lof * si)
          + 0.5).to(torch.int64)
    ys = (yf[:, None] + sc * (tables.kof * si + tables.lof * co)
          + 0.5).to(torch.int64)
    tl, tx, ty = (sample(pl, ys, xs) for pl in planes)
    if fixed:   # rotate each tap, then truncate toward zero
        tx, ty = (((-si) * tx + co * ty).to(torch.int32).to(torch.float32),
                  (co * tx + si * ty).to(torch.int32).to(torch.float32))
    taps = torch.stack([tl, tx, ty], dim=-1)
    taps = torch.cat([taps, torch.zeros_like(taps[:, :1])], dim=1)
    grouped = taps[:, cell_members(tables.cells)]    # [N, 29, M, 3]
    acc = grouped[:, :, 0]
    for j in range(1, grouped.shape[2]):
        acc = acc + grouped[:, :, j]
    if not fixed:
        acc = torch.stack([acc[..., 0],
                           (-si) * acc[..., 1] + co * acc[..., 2],
                           co * acc[..., 1] + si * acc[..., 2]], dim=-1)
    acc = acc.reshape(-1, 3 * NCELLS)
    acc = torch.where(live[:, None], acc, torch.zeros_like(acc))
    return angle, acc


def describe(iparams, fparams, planes, tables: DescribeTables,
             fixed: bool = False):
    """Orientation and cell sums of N slots (the port's ``describe`` on
    CPU tensors): (angle [N], acc [N, 87])."""
    if planes[0].shape[1] < WSIZE or planes[0].shape[2] < WSIZE:
        raise ValueError(f"planes must be [P, >={WSIZE}, >={WSIZE}]")
    return describe_plain(iparams, fparams, planes, tables, bool(fixed))
