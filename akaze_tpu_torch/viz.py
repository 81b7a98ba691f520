"""Host-side visualisation: keypoint / match rendering and PNG export.

A copy of ``akaze_tpu/viz.py`` (numpy and ``zlib`` only; the port keeps its
own copy so that it imports nothing of the JAX package): the same drawings
and the same PNG bytes.  The reference demo draws keypoints and match lines
with OpenCV (drawKeypoints main.cpp:28-40, drawMatches main.cpp:43-125,
imwrite main.cpp:224-226); here rendering is numpy and PNG encoding a
minimal self-contained writer.  These run on the host after the device
pipeline.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# BGR-ish palette matching the reference's cv::Scalar(255,0,0)/(0,255,0) use
KP_COLOR = (255, 64, 64)
LINE_COLOR = (64, 255, 64)


def to_rgb(gray: np.ndarray) -> np.ndarray:
    """[H, W] float [0,1] or uint8 -> [H, W, 3] uint8."""
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * 255.0 if g.max() <= 1.5 else g, 0, 255
                    ).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def draw_circle(img: np.ndarray, x: float, y: float, r: float, color,
                thickness: int = 1) -> None:
    """Rasterize a circle outline in place (midpoint-free, mask-based)."""
    h, w = img.shape[:2]
    r = max(float(r), 1.0)
    x0, x1 = int(max(0, x - r - 1)), int(min(w, x + r + 2))
    y0, y1 = int(max(0, y - r - 1)), int(min(h, y + r + 2))
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d = np.sqrt((xx - x) ** 2 + (yy - y) ** 2)
    ring = np.abs(d - r) <= 0.5 * thickness + 0.25
    img[y0:y1, x0:x1][ring] = color


def draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
              color) -> None:
    """Rasterize a 1px line segment in place."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip((x0 + ts * (x1 - x0)).round().astype(int), 0, w - 1)
    ys = np.clip((y0 + ts * (y1 - y0)).round().astype(int), 0, h - 1)
    img[ys, xs] = color


def draw_keypoints(gray, x, y, size, valid=None) -> np.ndarray:
    """Render keypoints as circles of their detected size
    (drawKeypoints, main.cpp:28-40)."""
    img = to_rgb(gray)
    x, y, size = map(np.asarray, (x, y, size))
    if valid is None:
        valid = np.ones(len(x), bool)
    for xi, yi, si, vi in zip(x, y, size, np.asarray(valid)):
        if vi:
            draw_circle(img, float(xi), float(yi), float(si), KP_COLOR)
    return img


def draw_matches(gray1, gray2, x1, y1, match_x, match_y, accepted,
                 horizontal: bool = True) -> np.ndarray:
    """Side-by-side match rendering (drawMatches, main.cpp:43-125:
    horizontal for the stock pair, vertical variant for the stereo pair)."""
    img1, img2 = to_rgb(gray1), to_rgb(gray2)
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    if horizontal:
        canvas = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
        canvas[:h1, :w1] = img1
        canvas[:h2, w1:w1 + w2] = img2
        ox, oy = w1, 0
    else:
        canvas = np.zeros((h1 + h2, max(w1, w2), 3), np.uint8)
        canvas[:h1, :w1] = img1
        canvas[h1:h1 + h2, :w2] = img2
        ox, oy = 0, h1
    for xa, ya, xb, yb, ok in zip(np.asarray(x1), np.asarray(y1),
                                  np.asarray(match_x), np.asarray(match_y),
                                  np.asarray(accepted)):
        if not ok:
            continue
        draw_circle(canvas, float(xa), float(ya), 2.0, KP_COLOR)
        draw_circle(canvas, float(xb) + ox, float(yb) + oy, 2.0, KP_COLOR)
        draw_line(canvas, float(xa), float(ya), float(xb) + ox,
                  float(yb) + oy, LINE_COLOR)
    return canvas


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit gray or RGB), stdlib-only."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        raw = img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        raw = img
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = raw.shape[:2]
    # prepend filter byte 0 to each scanline
    lines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1)
    compressed = zlib.compress(lines.tobytes(), 6)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for images written by ``write_png`` (and other
    8-bit non-interlaced gray/RGB/RGBA PNGs with filter types 0-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    w = h = None
    color_type = bit_depth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                             np.uint8).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, nch)
    return img[:, :, 0] if nch == 1 else img
