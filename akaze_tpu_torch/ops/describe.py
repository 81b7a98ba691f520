"""Kernel K2: per-keypoint orientation and MLDB cell sums.

Replaces ``akaze_tpu/ops/pallas_describe.py:orient_describe_banded``.  The
CUDA kernel is ``csrc/describe.cu``; its header says what it computes, what
bounds it on the card and what its design does about that.

``describe`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``describe_plain``, which evaluates the same
arithmetic in the same order with tensor ops.  The per-slot geometry comes
from ``descriptor.slot_params``; the comparisons and bit packing that
follow (``descriptor.finish_descriptors``) stay in PyTorch, as they stayed
in XLA outside the TPU kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..descriptor import WSIZE, _descriptor_window, _orient_grid

NCELLS = 29
H_PI = math.pi / 2.0
BIN_SCALE = 21.0 / math.pi

# atan(z)/z on z in [0, 1] as a degree-9 polynomial in z^2 (the TPU
# kernel's _atan2_poly; max abs error 7.6e-9)
_ATAN_COEFS = (9.9999999814e-01, -3.3333292795e-01, 1.9998532540e-01,
               -1.4264892055e-01, 1.0958362103e-01, -8.4276296054e-02,
               5.8457820666e-02, -3.1750529703e-02, 1.1257624297e-02,
               -1.8775595035e-03)


class DescribeTables(NamedTuple):
    """Static sampling tables of K2 on one device."""
    orient_w: torch.Tensor   # [121] f32 disc weights (0 outside r^2 < 36)
    lof: torch.Tensor        # [T] f32 tap column offsets l
    kof: torch.Tensor        # [T] f32 tap row offsets k
    cells: torch.Tensor      # [T, 3] int32 cell of the tap per grid, or -1


@lru_cache(maxsize=None)
def describe_tables(patsize: int, device) -> DescribeTables:
    l, k, M = _descriptor_window(patsize)
    ntaps = len(l)
    cells = np.full((ntaps, 3), -1, np.int32)
    for grid, (lo, hi) in enumerate(((0, 4), (4, 13), (13, NCELLS))):
        t, c = np.nonzero(M[:, lo:hi])
        cells[t, grid] = c + lo
    dev = torch.device(device)
    return DescribeTables(
        orient_w=torch.as_tensor(_orient_grid().reshape(-1), device=dev),
        lof=torch.as_tensor(l.astype(np.float32), device=dev),
        kof=torch.as_tensor(k.astype(np.float32), device=dev),
        cells=torch.as_tensor(cells, device=dev))


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


def describe_plain(iparams, fparams, planes, tables: DescribeTables):
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
    abin = ((atan2_poly(dy, dx) * BIN_SCALE).to(torch.int32) + 21).clamp(
        0, 41)
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
    taps = torch.stack([sample(pl, ys, xs) for pl in planes], dim=-1)
    taps = torch.cat([taps, torch.zeros_like(taps[:, :1])], dim=1)
    grouped = taps[:, cell_members(tables.cells)]    # [N, 29, M, 3]
    acc = grouped[:, :, 0]
    for j in range(1, grouped.shape[2]):
        acc = acc + grouped[:, :, j]
    rx = (-si) * acc[..., 1] + co * acc[..., 2]
    ry = co * acc[..., 1] + si * acc[..., 2]
    acc = torch.stack([acc[..., 0], rx, ry], dim=-1).reshape(-1, 3 * NCELLS)
    acc = torch.where(live[:, None], acc, torch.zeros_like(acc))
    return angle, acc


def _launch(iparams, fparams, planes, tables):
    n = iparams.shape[0]
    _, hp, wp = planes[0].shape
    angle = torch.empty(n, dtype=torch.float32, device=iparams.device)
    acc = torch.empty((n, 3 * NCELLS), dtype=torch.float32,
                      device=iparams.device)
    lib = _build.library()
    with torch.cuda.device(iparams.device):
        err = lib.akaze_describe(
            *(_build.ptr(pl) for pl in planes), _build.ptr(iparams),
            _build.ptr(fparams), _build.ptr(tables.orient_w),
            _build.ptr(tables.lof), _build.ptr(tables.kof),
            _build.ptr(tables.cells), _build.ptr(angle), _build.ptr(acc),
            n, hp, wp, tables.lof.shape[0], _build.stream_of(iparams))
    _build.check(err, "describe_kernel")
    describe.launches += 1
    return angle, acc


def describe(iparams: torch.Tensor, fparams: torch.Tensor, planes,
             tables: DescribeTables):
    """Orientation and MLDB cell sums of N keypoint slots.

    Args:
      iparams: [N, 8] int32 per slot (plane, y0, x0, oy, ox, iscale, live,
        0), from ``descriptor.slot_params``.
      fparams: [N, 2] float32 per slot (yf, xf), window-local.
      planes: (L, Lx, Ly), each [P, Hp, Wp] bfloat16 with Hp, Wp >= 128.
      tables: ``describe_tables(patsize, device)``.

    Returns (angle [N] float32 in [0, 2 pi), acc [N, 87] float32 with the
    cell sums at cell * 3 + channel, channels (L, rotated Lx, rotated Ly)).
    Dead slots (live == 0) return zeros.
    """
    dev = iparams.device
    n = iparams.shape[0]
    _build.check_tensor("iparams", iparams, torch.int32, (n, 8), dev)
    _build.check_tensor("fparams", fparams, torch.float32, (n, 2), dev)
    shape = planes[0].shape
    if len(shape) != 3 or shape[1] < WSIZE or shape[2] < WSIZE:
        raise ValueError(f"planes must be [P, >={WSIZE}, >={WSIZE}], "
                         f"got {tuple(shape)}")
    for name, pl in zip(("L", "Lx", "Ly"), planes):
        _build.check_tensor(name, pl, torch.bfloat16, shape, dev)
    for name in DescribeTables._fields:
        if getattr(tables, name).device != dev:
            raise ValueError(f"table {name} is not on {dev}")
    if dev.type == "cpu":
        return describe_plain(iparams, fparams, planes, tables)
    if dev.type == "cuda":
        return _launch(iparams, fparams, planes, tables)
    raise ValueError(f"no describe kernel for device {dev}")


describe.launches = 0
