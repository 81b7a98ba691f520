"""Batched homography estimation + RANSAC, and DLT PnP absolute pose.

Port of ``akaze_tpu/geometry/homography.py``, shaped as ``ransac.py``: all
hypotheses solved in one batched 9x9 eigenproblem (``linalg.py``'s
sync-free solver), scored as one [K, N] transfer-error matrix, refined by
IRLS (a fixed number of passes whose accept test is a ``torch.where``,
never a host branch).  The draw runs eagerly; the solve on the sets is a
compiled program (``programs.py``, JAX's static ``num_hyps`` and
``refit_iters``).  ``pnp_dlt`` lies in no JAX program and keeps
``torch.linalg``.

The eigenvector's sign is a convention of the solver, so H (and the DLT
projection of ``pnp_dlt``) is defined up to sign and scale; ``pnp_dlt``
fixes its sign by the points' depth majority.  The Hartley similarity T2 is
inverted in closed form (no ``torch.linalg.solve``, which syncs with the
host on CUDA to check its errors).

Conventions: x2 ~ H x1 (homogeneous); PnP solves world points X ->
normalised observations u with X_cam = R X + t.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import programs
from .linalg import _det3, smallest_eigenvector
from .ransac import check_sets, draw_minimal_sets


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _similarity(s, tx, ty):
    """[..., 3, 3] matrices [[s, 0, tx], [0, s, ty], [0, 0, 1]]."""
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([torch.stack([s, zero, tx], dim=-1),
                        torch.stack([zero, s, ty], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _hartley(x, weights=None):
    """Similarity T (and its inverse, and T x) bringing points to zero mean
    and sqrt(2) RMS radius: unnormalised float32 DLT loses the smallest
    eigenvector entirely at pixel scales.  Zero weights leave T finite (the
    1e-6 and 1e-12 guards).  Returns (xn, T, T^-1)."""
    w = torch.ones_like(x[..., 0]) if weights is None else weights
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)   # [..., 1]
    mean = (x * w[..., None]).sum(dim=-2, keepdim=True) / wsum[..., None]
    d = torch.sqrt(((x - mean) ** 2).sum(dim=-1))
    rms = torch.sqrt((d * d * w).sum(dim=-1, keepdim=True) / wsum) + 1e-12
    sc = math.sqrt(2.0) / rms                                   # [..., 1]
    xn = (x - mean) * sc[..., None]
    s, mx, my = sc[..., 0], mean[..., 0, 0], mean[..., 0, 1]
    return xn, _similarity(s, -s * mx, -s * my), _similarity(1.0 / s, mx, my)


def homography_from_points(x1, x2, weights=None):
    """Batched DLT homography (4+ correspondences), Hartley-normalised.

    Args: x1, x2 [..., N, 2]; weights optional [..., N].
    Returns H [..., 3, 3] (sign and scale free).
    """
    dtype = x1.dtype
    x1, T1, _ = _hartley(x1, weights)
    x2, _, T2inv = _hartley(x2, weights)
    x1, x2 = x1.to(torch.float64), x2.to(torch.float64)
    h1 = _homog(x1)                                         # [..., N, 3]
    zeros = torch.zeros_like(h1)
    u = x2[..., 0:1]
    v = x2[..., 1:2]
    # the 2-rows-per-point DLT system A h = 0
    row1 = torch.cat([zeros, -h1, v * h1], dim=-1)          # [..., N, 9]
    row2 = torch.cat([h1, zeros, -u * h1], dim=-1)
    A = torch.cat([row1, row2], dim=-2)                     # [..., 2N, 9]
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None].to(A.dtype)
    h = smallest_eigenvector(A.transpose(-1, -2) @ A).to(dtype)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalise: H = T2^-1 Hn T1
    return T2inv @ (Hn @ T1)


def homography_transfer_error(H, x1, x2):
    """Forward transfer error |H x1 - x2|^2, [..., N]; a point mapped to
    |z| < 1e-12 is divided by 1e-12."""
    p = _homog(x1) @ H.transpose(-1, -2)                    # [..., N, 3]
    z = p[..., 2:3]
    z = z.masked_fill(z.abs() < 1e-12, 1e-12)
    d = p[..., :2] / z - x2
    return (d * d).sum(dim=-1)


class HomographyResult(NamedTuple):
    H: torch.Tensor            # [3, 3]
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # scalar int32


@programs.jit(static_argnames=("num_hyps", "refit_iters"))
def _ransac_homography(x1, x2, valid, sets, threshold, num_hyps: int = 512,
                       refit_iters: int = 2) -> HomographyResult:
    """The solve of ``ransac_homography`` on int64 [num_hyps, 4]
    ``sets``: a compiled program."""
    check_sets(sets, num_hyps, 4)
    Hs = homography_from_points(x1[sets], x2[sets])         # [K, 3, 3]
    err = homography_transfer_error(Hs, x1[None], x2[None])  # [K, N]
    counts = ((err < threshold) & valid[None]).sum(dim=1)
    H = Hs.index_select(0, torch.argmax(counts).view(1))[0]

    # IRLS refit on the inlier set, kept only if it loses no inliers
    for _ in range(refit_iters):
        ok = (homography_transfer_error(H, x1, x2) < threshold) & valid
        H2 = homography_from_points(x1, x2, weights=ok.to(x1.dtype))
        c_new = ((homography_transfer_error(H2, x1, x2) < threshold)
                 & valid).sum()
        H = torch.where(c_new >= ok.sum(), H2, H)

    inliers = (homography_transfer_error(H, x1, x2) < threshold) & valid
    return HomographyResult(H=H, inliers=inliers,
                            num_inliers=inliers.sum().to(torch.int32))


def ransac_homography(generator, x1, x2, valid, threshold: float = 9.0,
                      num_hyps: int = 512, refit_iters: int = 2,
                      sets=None) -> HomographyResult:
    """RANSAC homography over putative matches and an IRLS refit.

    Args:
      generator: torch.Generator on the points' device for the draw
        (unused when ``sets`` is given).
      x1, x2: [N, 2] matched coordinates (pixel or normalised).
      valid: [N] bool putative-match validity.
      threshold: squared transfer error in the same units.
      num_hyps: number of minimal sets.
      refit_iters: weighted refits on the winning inlier set.
      sets: optional [num_hyps, 4] row indices to use instead of a draw.
    """
    if sets is None:
        sets = draw_minimal_sets(generator, valid, num_hyps, 4)
    return _ransac_homography(x1, x2, valid,
                              sets.to(device=x1.device, dtype=torch.int64),
                              threshold, num_hyps=num_hyps,
                              refit_iters=refit_iters)


def pnp_dlt(X, u, weights=None):
    """DLT absolute pose from 6+ world <-> normalised-image
    correspondences.

    Args: X [N, 3] world points; u [N, 2] normalised camera coordinates;
    weights optional [N].
    Returns (R [3, 3], t [3]) with X_cam = R X + t (sign fixed by the depth
    majority, rotation orthonormalised).
    """
    n = X.shape[0]
    Xh = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)],
                   dim=1)                                   # [N, 4]
    zeros = torch.zeros_like(Xh)
    row1 = torch.cat([Xh, zeros, -u[:, 0:1] * Xh], dim=1)  # [N, 12]
    row2 = torch.cat([zeros, Xh, -u[:, 1:2] * Xh], dim=1)
    A = torch.cat([row1, row2], dim=0)                      # [2N, 12]
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=0)[:, None]
    _, evecs = torch.linalg.eigh(A.T @ A)
    p = evecs[:, 0].reshape(3, 4)
    # P is defined up to scale AND sign; visible points need positive
    # depth, so fix the sign by the depth majority first (sign(0) = 0)
    z = X @ p[:, :3].T + p[:, 3]
    p = p * (1.0 - 2.0 * (torch.sign(z[:, 2]).sum() < 0).to(p.dtype))
    M = p[:, :3]
    # for a clean projection M = s R with s > 0, so det(M) = s^3 > 0
    scale = torch.clamp(_det3(M), min=1e-12).pow(1.0 / 3.0)
    M = M / scale
    tv = p[:, 3] / scale
    # nearest proper rotation: U diag(1, 1, det(U Vt)) Vt
    U, _, Vt = torch.linalg.svd(M)
    one = torch.ones_like(scale)
    R = (U * torch.stack([one, one, _det3(U @ Vt)])) @ Vt
    return R, tv
