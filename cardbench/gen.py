"""Seeded inputs, rendered on the device.

Two distributions, the same as the repository's host generators draw,
each blob drawn only over its own window:

* ``texture``: Gaussian blobs at five scales with random signs, plus
  noise (``chip_smoke.synthetic_texture``), for the pair and photo cells;
* ``blob_world``: the SLAM route's world of positive blobs
  (``io.synthetic_sequence``), cropped into frames along a route.

Blobs are summed as 40-bit fixed-point integers (exact and independent of
the order in which the device adds them), so one seed gives the same
image bit for bit on every run.  Every draw comes from a
``torch.Generator`` on the device, seeded from (seed, purpose, index)
through numpy's ``SeedSequence``, so any whole seed (also past 2**63) is
taken and different seeds or purposes give independent streams.
"""

from __future__ import annotations

import numpy as np
import torch

FIXED_ONE = float(1 << 40)     # fixed-point unit of the blob sums

# (sigma, blobs per 960x1280 image) of the texture
TEXTURE_LEVELS = ((2.0, 5000), (3.5, 3000), (6.0, 1200), (10.0, 400),
                  (16.0, 120))
TEXTURE_NOISE = 0.02
WORLD_NOISE = 0.03


def generator(device, seed: int, *purpose: int) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *purpose])
    g = torch.Generator(device=device)
    g.manual_seed(int(words.generate_state(1, np.uint64)[0]) >> 1)
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                       dtype=torch.float64)


def _splat(acc, cy, cx, amp, sigma, reach, square: bool):
    """Add each blob a * exp(-d^2 / 2 s^2) into the int64 image ``acc``
    over its own window: offsets -reach..reach around (int(cy), int(cx)),
    all blobs of one call sharing ``reach``; ``square`` keeps the window
    square (the texture), else only |offset - frac| < 4 s per axis (the
    world)."""
    h, w = acc.shape
    dev = acc.device
    off = torch.arange(-reach, reach + 1, device=dev, dtype=torch.float64)
    iy, ix = cy.floor(), cx.floor()
    dy = off[None, :] + iy[:, None] - cy[:, None]            # [n, k]
    dx = off[None, :] + ix[:, None] - cx[:, None]
    s2 = 2.0 * sigma[:, None] * sigma[:, None]
    if square:
        gy, gx = torch.exp(-dy * dy / s2), torch.exp(-dx * dx / s2)
        val = amp[:, None, None] * gy[:, :, None] * gx[:, None, :]
    else:
        lim = 4.0 * sigma[:, None, None]
        d2 = dy[:, :, None] ** 2 + dx[:, None, :] ** 2
        val = amp[:, None, None] * torch.exp(-d2 / s2[:, :, None])
        val = torch.where((dy.abs()[:, :, None] < lim)
                          & (dx.abs()[:, None, :] < lim), val,
                          torch.zeros_like(val))
    rows = (iy[:, None] + off[None, :]).long()               # [n, k]
    cols = (ix[:, None] + off[None, :]).long()
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    flat = rows[:, :, None] * w + cols[:, None, :]
    q = torch.round(val * FIXED_ONE).long()
    acc.view(-1).index_add_(0, flat[inside], q[inside])


def texture(h: int, w: int, seed: int, index: int, device) -> torch.Tensor:
    """[h, w] float32 texture in [0, 1]: the blob levels of
    ``TEXTURE_LEVELS`` (counts scaled to the area, amplitudes 0.2-0.6 with
    random signs, windows of 3 sigma + 1), normalised by the largest
    magnitude, plus Gaussian noise, clipped."""
    g = generator(device, seed, 1, index)
    acc = torch.zeros((h, w), dtype=torch.int64, device=device)
    area = h * w / (960 * 1280)
    for sigma, count in TEXTURE_LEVELS:
        n = max(1, int(count * area))
        cy = _uniform(g, n, 0.0, h, device)
        cx = _uniform(g, n, 0.0, w, device)
        amp = _uniform(g, n, 0.2, 0.6, device)
        sign = torch.randint(0, 2, (n,), generator=g, device=device) * 2 - 1
        reach = int(3 * sigma) + 1
        # blobs in chunks, so that no call holds more than ~16M taps
        step = max(1, (1 << 24) // (2 * reach + 1) ** 2)
        for i in range(0, n, step):
            sl = slice(i, i + step)
            _splat(acc, cy[sl], cx[sl], amp[sl] * sign[sl],
                   torch.full_like(cy[sl], sigma), reach, square=True)
    img = acc.to(torch.float64) / FIXED_ONE
    img = 0.5 + 0.5 * img / img.abs().max().clamp(min=1e-9)
    img = img + TEXTURE_NOISE * torch.randn((h, w), generator=g,
                                            device=device,
                                            dtype=torch.float64)
    return img.clamp(0.0, 1.0).to(torch.float32)


def blob_world(h: int, w: int, n_blobs: int, seed: int, index: int,
               device) -> torch.Tensor:
    """[h, w] float32 world in [0, 1]: ``n_blobs`` positive blobs
    (centres 10 px inside the edges, sigma 2-8, amplitude 0.3-1.0, each
    over |dy|, |dx| < 4 sigma), plus noise, normalised by the maximum and
    clipped."""
    g = generator(device, seed, 2, index)
    acc = torch.zeros((h, w), dtype=torch.int64, device=device)
    cy = _uniform(g, n_blobs, 10.0, h - 10.0, device)
    cx = _uniform(g, n_blobs, 10.0, w - 10.0, device)
    sigma = _uniform(g, n_blobs, 2.0, 8.0, device)
    amp = _uniform(g, n_blobs, 0.3, 1.0, device)
    reach = 32                                   # 4 sigma at sigma = 8
    step = max(1, (1 << 24) // (2 * reach + 1) ** 2)
    for i in range(0, n_blobs, step):
        sl = slice(i, i + step)
        _splat(acc, cy[sl], cx[sl], amp[sl], sigma[sl], reach, square=False)
    world = acc.to(torch.float64) / FIXED_ONE
    world = world + WORLD_NOISE * torch.randn((h, w), generator=g,
                                              device=device,
                                              dtype=torch.float64)
    world = world / world.max().clamp(min=1e-6)
    return world.clamp(0.0, 1.0).to(torch.float32)


def shifts(seed: int, count: int, max_shift: int, index: int = 0):
    """``count`` integer (dy, dx) shifts, each in [-max_shift, max_shift],
    drawn from the seed on the host."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 3, index])
    return [tuple(int(v) for v in rng.integers(-max_shift, max_shift + 1, 2))
            for _ in range(count)]


def route(out_frames: int, step_px: int):
    """The SLAM route over a row of ``4 * (out_frames - 1) + 1`` positions a
    quarter step apart: every fourth out, then back a quarter step off.
    Returns (positions' x offsets in px, the route's order of them)."""
    q = step_px // 4
    n = 4 * (out_frames - 1) + 1
    order = list(range(0, n, 4)) + list(range(n - 2, 0, -4))
    return [k * q for k in range(n)], order


def route_frames(h: int, w: int, out_frames: int, step_px: int,
                 density: float, seed: int, device):
    """Frames of the SLAM route (``chip_smoke.slam_route``'s layout): a
    world 40 px taller and 2 (q n + 20) px wider than a frame, blobs at
    ``density`` per px, frames cropped at x = max_x + k q, quantised to
    0..255 and read back as float32 in [0, 1].  Returns (frames [N, h, w]
    on ``device``, true (dy, dx) offsets [N, 2])."""
    xs, order = route(out_frames, step_px)
    q = step_px // 4
    n = len(xs)
    max_y, max_x = 20, int(q * n + 20)
    big_h, big_w = h + 2 * max_y, w + 2 * max_x
    n_blobs = int(density * (h + 40) * (w + 2 * int(q * n + 20)))
    world = blob_world(big_h, big_w, n_blobs, seed, 0, device)
    frames = torch.stack([world[max_y:max_y + h,
                                max_x + xs[k]:max_x + xs[k] + w]
                          for k in order])
    frames = torch.floor(frames * 255.0) / 255.0
    offsets = np.asarray([(0.0, float(xs[k])) for k in order], np.float32)
    return frames.contiguous(), offsets


def crop_offsets(seed: int, index: int, count: int, span_y: int,
                 span_x: int):
    """``count`` integer (y, x) crop corners, uniform over a world whose
    crops may start anywhere in [0, span_y] x [0, span_x]."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 4, index])
    ys = rng.integers(0, span_y + 1, count)
    xs = rng.integers(0, span_x + 1, count)
    return [(int(a), int(b)) for a, b in zip(ys, xs)]
