"""Batched-hypothesis RANSAC for the essential matrix.

Port of ``akaze_tpu/geometry/ransac.py``: K minimal sets are drawn at once,
K eigenproblems solved in one batch, the K x N Sampson-error matrix scored,
and the best hypothesis refit on its inlier set (IRLS, a fixed number of
passes whose accept test is a ``torch.where``, never a host branch).

The draw is the port's own.  PyTorch cannot reproduce
``jax.random.categorical``, so ``draw_minimal_sets`` draws uniformly over
the valid rows, with replacement, on the mask's device and without a host
sync.  The solve on the drawn sets is ``_ransac_essential``, its threshold
a 0-d tensor as the port's programs pass it.  A random state is a
uint32[2] key on the host, as in the JAX package: ``split_key`` advances it
by a fixed rule and ``sets_from_key`` seeds a device generator from it, so
a key restored from either package's checkpoint is a valid state.  The two
packages' draws from one key differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .epipolar import essential_from_eight, recover_pose, sampson_error


class RansacResult(NamedTuple):
    E: torch.Tensor            # [3, 3] best essential matrix
    R: torch.Tensor            # [3, 3] recovered rotation (X2 = R X1 + t)
    t: torch.Tensor            # [3] unit translation
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # scalar int32


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64's finaliser of a 64-bit state advanced by its constant."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _key_of(x: int) -> np.ndarray:
    return np.asarray([x >> 32, x & 0xFFFFFFFF], np.uint32)


def _int_of(key) -> int:
    k = np.asarray(key, np.uint32)
    return (int(k[0]) << 32) | int(k[1])


def make_key(seed: int) -> np.ndarray:
    """uint32[2] key of ``seed``: the words of ``jax.random.PRNGKey(seed)``
    for a seed below 2^32."""
    return _key_of(seed & _M64)


def split_key(key):
    """(next key, subkey) of a uint32[2] key, on the host."""
    x = _int_of(key)
    return _key_of(_mix64(x)), _key_of(_mix64(x ^ 0x5851F42D4C957F2D))


def draw_minimal_sets(generator: torch.Generator, mask: torch.Tensor,
                      num_hyps: int, sample_size: int = 8) -> torch.Tensor:
    """[K, S] int64 row indices drawn uniformly, with replacement, from the
    rows where ``mask`` is True, on ``mask``'s device with ``generator``
    (a generator of that device).  No host sync; with no valid row every
    index is still in range (the last row).  Duplicates inside a set are
    allowed, as in the JAX package: the hypothesis degenerates and scores
    out."""
    n = mask.shape[0]
    u = torch.rand((num_hyps, sample_size), generator=generator,
                   device=mask.device)
    cum = torch.cumsum(mask.to(torch.int64), 0)
    count = cum[-1]
    rank = torch.minimum((u * count).to(torch.int64), count - 1).clamp(min=0)
    return torch.searchsorted(cum, rank + 1).clamp(max=n - 1)


def sets_from_key(key, mask: torch.Tensor, num_hyps: int,
                  sample_size: int = 8) -> torch.Tensor:
    """``draw_minimal_sets`` with a generator on ``mask``'s device seeded
    from the uint32[2] ``key``."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(_int_of(key))
    return draw_minimal_sets(gen, mask, num_hyps, sample_size)


def check_sets(sets: torch.Tensor, num_hyps: int, size: int):
    if tuple(sets.shape) != (num_hyps, size):
        raise ValueError(f"sets of shape {tuple(sets.shape)}, expected "
                         f"({num_hyps}, {size})")


def _ransac_essential(x1, x2, valid, sets, threshold, num_hyps: int = 512,
                      refit_iters: int = 2) -> RansacResult:
    """The solve of ``ransac_essential`` on int64 [num_hyps, 8] ``sets``: a
    compiled program."""
    check_sets(sets, num_hyps, 8)
    Es = essential_from_eight(x1[sets], x2[sets])         # [K, 3, 3]
    err = sampson_error(Es, x1[None], x2[None])           # [K, N]
    counts = ((err < threshold) & valid[None]).sum(dim=1)
    E = Es.index_select(0, torch.argmax(counts).view(1))[0]

    # IRLS refit on the inlier set, kept only if it loses no inliers
    for _ in range(refit_iters):
        ok = (sampson_error(E, x1, x2) < threshold) & valid
        E2 = essential_from_eight(x1, x2, weights=ok.to(x1.dtype))
        c_new = ((sampson_error(E2, x1, x2) < threshold) & valid).sum()
        E = torch.where(c_new >= ok.sum(), E2, E)

    inliers = (sampson_error(E, x1, x2) < threshold) & valid
    R, t, cheir = recover_pose(E, x1, x2, inliers)
    good = inliers & cheir
    return RansacResult(E=E, R=R, t=t, inliers=good,
                        num_inliers=good.sum().to(torch.int32))


def normalize_points(x_px, fx, fy, cx, cy):
    """Pixel -> normalised camera coordinates (K^-1 x)."""
    return torch.stack([(x_px[..., 0] - cx) / fx,
                        (x_px[..., 1] - cy) / fy], dim=-1)
