"""Reductions and the conjugate-gradient solver shared by the PGO and BA
solvers.

``segment_sum`` replaces ``jax.ops.segment_sum``.  ``index_add_`` would
add with atomics on CUDA, so a sum would change from run to run; here a
sum over segments is a product with a one-hot matrix (built once per
solve), which the card repeats bit for bit.  The problems are small
(segments: cameras, landmarks or poses of one window or graph), so the
dense product costs little.

``cg`` reproduces ``jax.scipy.sparse.linalg.cg`` (x0 = 0, stop when
|r|^2 <= tol^2 |b|^2, at most ``maxiter`` steps) without a host test per
step: it always runs ``maxiter`` steps and freezes the iterate once the
test holds, which gives the result of the early exit.
"""

from __future__ import annotations

import torch


def one_hot(ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """[n, M] matrix whose row s marks the entries of ``ids`` equal to s."""
    seg = torch.arange(n, device=ids.device)
    return (ids.to(torch.int64)[None, :] == seg[:, None]).to(dtype)


def segment_sum(values: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """Sum of ``values`` [M, ...] per segment of the one-hot ``hot``
    [n, M]: [n, ...]."""
    m = values.shape[0]
    return (hot @ values.reshape(m, -1)).reshape(
        (hot.shape[0],) + tuple(values.shape[1:]))


def _vdot(x, y):
    return torch.sum(x * y)


def cg(matvec, b: torch.Tensor, maxiter: int, tol: float = 1e-5):
    """Conjugate gradients on the symmetric positive (semi)definite
    operator ``matvec`` from x0 = 0; ``maxiter`` steps with converged
    iterates frozen."""
    atol2 = (tol * tol) * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = _vdot(r, r)
    for _ in range(maxiter):
        go = gamma > atol2
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = _vdot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        gamma = torch.where(go, gamma_new, gamma)
    return x
