"""Minimal grayscale image I/O (the demo harness uses OpenCV imread,
main.cpp:141-150; we avoid the hard dependency)."""

from __future__ import annotations

import numpy as np


def load_pgm(path: str) -> np.ndarray:
    """Read a binary (P5) or ASCII (P2) PGM file as uint8/uint16 [H, W]."""
    with open(path, "rb") as f:
        data = f.read()

    # tokenize header, skipping comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), \
        int(tokens[3])
    if magic == b"P5":
        i += 1  # single whitespace after maxval
        dtype = np.uint8 if maxval < 256 else ">u2"
        arr = np.frombuffer(data, dtype=dtype, count=w * h, offset=i)
        return arr.reshape(h, w).astype(np.uint8 if maxval < 256 else
                                        np.uint16)
    if magic == b"P2":
        vals = np.fromstring(data[i:], dtype=int, sep=" ")  # pragma: no cover
        return vals[:w * h].reshape(h, w).astype(np.uint8)
    raise ValueError(f"unsupported PGM magic {magic!r}")


def save_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def load_gray(path: str) -> np.ndarray:
    """Load any grayscale image as uint8 [H, W]; prefers the stdlib-free PGM
    path, falls back to PIL for other formats."""
    if path.lower().endswith(".pgm"):
        return load_pgm(path)
    from PIL import Image  # lazy; only for non-PGM formats
    return np.asarray(Image.open(path).convert("L"))
