"""Sync-free small eigensolvers for the two-view programs.

``torch.linalg.eigh`` and ``torch.linalg.svd`` read cuSOLVER's ``info`` on
the host, which stops the host and forbids graph capture.  The two solvers
here are a fixed sequence of plain PyTorch ops: no read on the host, no
error check and no Python branch on data, so that the two-view and
homography RANSAC run inside captured programs (``programs.py``) and the
CPU runs exactly the sequence the card runs.  Both compute in float64 and
return the input's dtype.

  - ``smallest_eigenvector``: the eigenvector of the smallest eigenvalue of
    symmetric positive-semidefinite [..., n, n] matrices (A^T A of the
    8-point and DLT systems), by inverse iteration on the whole basis: the
    inverse of M / tr(M) + ridge * I (``torch.linalg.inv_ex`` without its
    error check, which reads nothing on the host), squared ``_SQUARINGS``
    times, and its column of largest norm.  That column holds at least
    1/sqrt(n) of the wanted eigenvector before the squarings, so no start
    vector can be orthogonal to it.  The ridge (1e-10 of the trace) keeps
    the inverse finite on null spaces of any dimension; any null vector is
    then returned.  Where the next eigenvalue is close, the vector is
    tilted toward its eigenvector, but its Rayleigh quotient stays close
    to the smallest eigenvalue (see ``smallest_eigenvector``).
  - ``svd3``: a 3x3 SVD from the symmetric eigenproblem of E^T E, solved in
    closed form as Eberly's robust eigensolver ("A Robust Eigensolver for
    3x3 Symmetric Matrices", Geometric Tools, 2014): the eigenvalues by the
    trigonometric formula; the eigenvector of whichever extreme eigenvalue
    is farther from the middle one, by the largest cross product of two
    rows of (E^T E - lambda I) (a rank-2 matrix, also when the other two
    eigenvalues are equal); the other two by a 2x2 rotation in the plane
    orthogonal to it.  Repeated singular values, as in every essential
    matrix (s, s, 0), therefore need no special case.  U = E V / S, with
    U's third column the cross product of the first two.

Sign convention: each returned eigenvector, and each column of ``svd3``'s
V, has its largest-magnitude component positive (the first of equal
ones); U's first two columns follow from E v = s u, and its third is
signed so that u3 . E v3 >= 0.  Columns whose singular value is 0 are
completed to an orthonormal U.
"""

from __future__ import annotations

import math

import torch

from .tables import const_table

_RIDGE = 1e-10        # relative to the trace of the normalised matrix
# squarings of the inverse: a component of eigenvalue lambda_i shrinks
# against lambda_1's by (lambda_1 / lambda_i)^32
_SQUARINGS = 5
_TINY = 1e-300        # a positive floor for divisors that may be 0
# phase offsets of the trigonometric eigenvalues, in descending order
_PHASES = (0.0, 4.0 * math.pi / 3.0, 2.0 * math.pi / 3.0)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _positive_largest(v, dim=-1):
    """``v`` with each vector along ``dim`` signed so that its component of
    largest magnitude is positive."""
    i = v.abs().argmax(dim=dim, keepdim=True)
    return v * torch.where(torch.take_along_dim(v, i, dim=dim) < 0, -1.0,
                           1.0)


def _unit(v):
    """``v / |v|`` along the last axis, and |v|^2."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v / torch.sqrt(n2.clamp(min=_TINY)), n2


def _orthogonal_unit(w):
    """A unit vector orthogonal to unit 3-vectors ``w``: w crossed with the
    axis least aligned with it (|w x e| >= sqrt(2/3))."""
    k = w.abs().argmin(dim=-1, keepdim=True)
    axis = torch.zeros_like(w).scatter_(-1, k, 1.0)
    return _unit(torch.linalg.cross(w, axis))[0]


def smallest_eigenvector(M):
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    matrices ``M`` [..., n, n], with its largest-magnitude component
    positive (see the module docstring).  Finite for any PSD input, the
    zero matrix and null spaces of dimension >= 2 included.

    What is guaranteed where the eigenvalues l_1 <= l_2 <= ... are close:
    in exact arithmetic the Rayleigh quotient v^T M v exceeds l_1 by at
    most n * sum_{i >= 2} (l_i - l_1) * ((l_1 + e) / (l_i + e))^64, with
    e = 1e-10 tr(M) (the ridge): nothing beyond rounding once l_2 >= 4 l_1,
    0.018 l_1 where only l_2 is close, at l_1 / l_2 = 0.95.  The vector
    itself may then lie up to sqrt(n) (l_1 / l_2)^32 off l_1's
    eigenvector, toward l_2's (``tests/test_torch_linalg.py`` holds both).
    """
    n = M.shape[-1]
    A = M.to(torch.float64)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    P = torch.linalg.inv_ex(A / tr.clamp(min=_TINY) + _RIDGE * _eye(n, A),
                            check_errors=False).inverse
    for _ in range(_SQUARINGS):
        # P stays positive definite: its trace bounds every entry
        P = P @ P
        P = P / torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    col = (P * P).sum(-2).argmax(dim=-1)[..., None, None]
    v = torch.take_along_dim(P, col.expand(P.shape[:-1] + (1,)), dim=-1)
    return _positive_largest(_unit(v[..., 0])[0]).to(M.dtype)


def _det3(M):
    """Determinant of [..., 3, 3] matrices (closed form)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :],
                                                       M[..., 2, :]), dim=-1)


def _sym_eig3(G):
    """Eigenvectors of symmetric [..., 3, 3] float64 matrices ``G``, as the
    columns of V in descending order of their eigenvalues."""
    eye = _eye(3, G)
    q = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 3.0
    D = G - q[..., None, None] * eye
    p = torch.sqrt((D * D).sum(dim=(-2, -1)) / 6.0)
    r = (_det3(D / p.clamp(min=_TINY)[..., None, None]) / 2.0).clamp(-1, 1)
    phase = const_table(_PHASES, G.dtype, G.device)
    lam = q[..., None] + 2.0 * p[..., None] * torch.cos(
        torch.acos(r)[..., None] / 3.0 + phase)          # descending
    l1, l2, l3 = lam.unbind(-1)
    # the extreme eigenvalue farther from the middle one is isolated by at
    # least half the spread: G - alpha I has rank 2 unless G = alpha I
    small = (l2 - l3) >= (l1 - l2)
    alpha = torch.where(small, l3, l1)
    R = G - alpha[..., None, None] * eye
    C = torch.linalg.cross(R, R.roll(-1, dims=-2))       # rows' cross pairs
    best = (C * C).sum(-1).argmax(dim=-1, keepdim=True)
    w, n2 = _unit(torch.take_along_dim(C, best[..., None], dim=-2)[..., 0, :])
    # G = alpha I: every vector is an eigenvector, and C is 0
    w = torch.where(n2 > 0, w, eye[2])
    u = _orthogonal_unit(w)
    Q = torch.stack([u, torch.linalg.cross(w, u)], dim=-1)   # [..., 3, 2]
    S = Q.transpose(-1, -2) @ G @ Q
    theta = 0.5 * torch.atan2(2.0 * S[..., 0, 1], S[..., 0, 0] - S[..., 1, 1])
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      dim=-2)
    pair = Q @ rot                # larger eigenvalue first, in the plane
    return torch.where(small[..., None, None],
                       torch.cat([pair, w[..., None]], dim=-1),
                       torch.cat([w[..., None], pair], dim=-1))


def svd3(M):
    """SVD of [..., 3, 3] matrices: (U, S, Vt) with M = U diag(S) Vt, S
    descending and non-negative, U and V orthonormal (either handedness;
    see the module docstring for the signs)."""
    E = M.to(torch.float64)
    V = _positive_largest(_sym_eig3(E.transpose(-1, -2) @ E), dim=-2)
    Y = E @ V                                             # columns s_i u_i
    y1, y2, y3 = Y.unbind(-1)
    u1, n1 = _unit(y1)
    e0 = _eye(3, E)[0]
    u1 = torch.where(n1 > 0, u1, e0)
    u2, n2 = _unit(y2 - (u1 * y2).sum(-1, keepdim=True) * u1)
    u2 = torch.where(n2 > 0, u2, _orthogonal_unit(u1))
    u3 = torch.linalg.cross(u1, u2)
    u3 = u3 * torch.where((u3 * y3).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    S = torch.sqrt((Y * Y).sum(-2))
    U = torch.stack([u1, u2, u3], dim=-1)
    return (U.to(M.dtype), S.to(M.dtype), V.transpose(-1, -2).to(M.dtype))
