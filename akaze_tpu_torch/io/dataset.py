"""Dataset utilities: image-sequence readers and a synthetic generator.

A copy of ``akaze_tpu/io/dataset.py`` (numpy only; the port keeps its own
copy so that it imports nothing of the JAX package): a glob-ordered frame
sequence, KITTI-odometry pose files, the absolute trajectory error, and a
seeded synthetic sequence whose frames equal the JAX package's byte for
byte.  ``FrameSequence`` decodes frames synchronously; the JAX package's
native threaded prefetch of ``.pgm`` frames waits for the port of
``native.py`` (it yields the same frames).

``projected_sequence`` is the port's own: keypoints of a 3-D scene, whose
two-view geometry is not degenerate, unlike the plane of
``synthetic_sequence``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .image import load_gray


class FrameSequence:
    """Ordered grayscale frame sequence from a directory or glob pattern."""

    def __init__(self, pattern: str):
        if os.path.isdir(pattern):
            paths: List[str] = []
            for ext in ("*.pgm", "*.png", "*.jpg"):
                paths.extend(glob.glob(os.path.join(pattern, ext)))
            self.paths = sorted(paths)
        else:
            self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise FileNotFoundError(f"no frames match {pattern!r}")

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        for p in self.paths:
            yield load_gray(p)


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry ground-truth format: each line is a row-major 3x4
    [R | t] matrix (camera-to-world).  Returns (R [N,3,3], t [N,3])."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    return (rows[:, :, :3].astype(np.float32),
            rows[:, :, 3].astype(np.float32))


def save_kitti_poses(path: str, R: np.ndarray, t: np.ndarray) -> None:
    mat = np.concatenate([np.asarray(R), np.asarray(t)[:, :, None]], axis=2)
    np.savetxt(path, mat.reshape(len(mat), 12), fmt="%.9e")


def ate_rmse(t_est: np.ndarray, t_gt: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after optional
    similarity (Umeyama) alignment, the KITTI/TUM metric."""
    est = np.asarray(t_est, np.float64)
    gt = np.asarray(t_gt, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shapes differ: {est.shape} vs {gt.shape}")
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        e, g = est - mu_e, gt - mu_g
        cov = g.T @ e / len(e)
        U, D, Vt = np.linalg.svd(cov)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        var_e = (e ** 2).sum() / len(e)
        s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
        est = s * (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def synthetic_sequence(rng, n_frames: int = 8, size: Tuple[int, int] =
                       (240, 320), shift_per_frame: Tuple[float, float] =
                       (4.0, 2.0), n_blobs: int = 60):
    """Render a translating view over a random blob field.

    Returns (frames [N, H, W] uint8, true per-frame pixel offsets [N, 2]).
    Pure-translation imagery: enough to exercise detection, matching and
    tracking loops with known pixel-space ground truth.
    """
    h, w = size
    dy, dx = shift_per_frame
    max_y = int(abs(dy) * n_frames + 20)
    max_x = int(abs(dx) * n_frames + 20)
    big_h, big_w = h + 2 * max_y, w + 2 * max_x
    yy, xx = np.mgrid[0:big_h, 0:big_w].astype(np.float64)
    world = np.zeros((big_h, big_w))
    cy = rng.uniform(10, big_h - 10, n_blobs)
    cx = rng.uniform(10, big_w - 10, n_blobs)
    sig = rng.uniform(2, 8, n_blobs)
    amp = rng.uniform(0.3, 1.0, n_blobs)
    for c_y, c_x, s, a in zip(cy, cx, sig, amp):
        m = ((np.abs(yy - c_y) < 4 * s) & (np.abs(xx - c_x) < 4 * s))
        world[m] += a * np.exp(-((yy[m] - c_y) ** 2 + (xx[m] - c_x) ** 2)
                               / (2 * s * s))
    world += 0.03 * rng.standard_normal(world.shape)
    world = np.clip(world / max(world.max(), 1e-6), 0, 1)

    frames = []
    offsets = []
    for k in range(n_frames):
        oy = int(round(max_y + k * dy))
        ox = int(round(max_x + k * dx))
        frames.append((world[oy:oy + h, ox:ox + w] * 255).astype(np.uint8))
        offsets.append((oy - max_y, ox - max_x))
    return np.stack(frames), np.asarray(offsets, np.float32)


def projected_sequence(rng, n_out: int = 3, step: float = 0.4,
                       n_pts: int = 400, noise_px: float = 0.3,
                       size: Tuple[int, int] = (480, 640),
                       focal: float = 500.0, max_pts: int = 512
                       ) -> Tuple[List[Dict[str, np.ndarray]], np.ndarray]:
    """Keypoints seen along an out-and-back camera route through a random
    3-D point cloud (depths 4..12), each point with its own random
    descriptor, projected with pixel noise.

    The route goes out along x in ``n_out`` steps of ``step`` and comes back
    half a step off the outbound positions and 0.05 to the side, with a
    small yaw.  Frame k's features are a dict of the ``Features`` fields as
    numpy arrays of ``max_pts`` slots (slot = point; words uint32; valid =
    visible), for ``pipeline.features_from_numpy``; the intrinsics are
    (focal, focal, w / 2, h / 2).  Returns (features per frame, camera
    centres [N, 3]).
    """
    h, w = size
    X = rng.uniform([-3.0, -2.0, 4.0], [3.0 + step * n_out, 2.0, 12.0],
                    (n_pts, 3)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, (n_pts, 16), dtype=np.uint64).astype(
        np.uint32)
    words[:, 15] &= np.uint32((1 << 6) - 1)      # 486 live bits
    centres = ([(step * k, 0.0, 0.0) for k in range(n_out)]
               + [(step * k - step / 2, 0.05, 0.0)
                  for k in range(n_out - 1, 0, -1)])
    pad = max_pts - n_pts
    frames = []
    for k, c in enumerate(centres):
        a = 0.01 * np.sin(k)                     # yaw about the y axis
        R = np.asarray([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]], np.float32)
        Xc = X @ R.T - R @ np.asarray(c, np.float32)
        px = focal * Xc[:, 0] / Xc[:, 2] + w / 2
        py = focal * Xc[:, 1] / Xc[:, 2] + h / 2
        vis = (Xc[:, 2] > 0.1) & (px > 0) & (px < w) & (py > 0) & (py < h)
        noise = rng.normal(0.0, noise_px, (2, max_pts)).astype(np.float32)

        def slots(v, fill=0):
            return np.concatenate([v, np.full((pad,) + v.shape[1:], fill,
                                              v.dtype)])

        frames.append(dict(
            x=slots(px.astype(np.float32)) + noise[0],
            y=slots(py.astype(np.float32)) + noise[1],
            size=slots(np.full(n_pts, 4.0, np.float32)),
            layer=slots(np.zeros(n_pts, np.int32)),
            response=slots(np.ones(n_pts, np.float32)),
            angle=slots(np.zeros(n_pts, np.float32)),
            words=slots(words), valid=slots(vis, False),
            count=np.int32(vis.sum()), overflow=np.bool_(False)))
    return frames, np.asarray(centres, np.float32)
