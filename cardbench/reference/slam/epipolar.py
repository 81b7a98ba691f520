"""Two-view epipolar geometry on batched tensors.

Port of ``akaze_tpu/geometry/epipolar.py``.  The essential matrix comes
from the normalised 8-point algorithm as a batched 9x9 symmetric
eigenproblem (the null space of A is the smallest eigenvector of A^T A);
the projection onto the essential manifold and the pose decomposition use
3x3 SVDs.  Both are ``linalg.py``'s sync-free solvers (float64 inside), so
that the RANSAC programs can be captured.  The sign of each vector is a
convention of the solver, so E is defined up to sign (and the 8-point E up
to scale); the det(U), det(V) fixes keep the decomposition's rotations
proper whatever the signs.

Conventions: points are normalised camera coordinates (pixel coordinates
premultiplied by K^-1), x2^T E x1 = 0, and the recovered pose (R, t) maps
camera-1 points into camera 2: X2 = R X1 + t.
"""

from __future__ import annotations

import torch

from .tables import const_table
from .linalg import _det3, smallest_eigenvector, svd3

# singular values of the essential manifold, and the decomposition's W
_S_ESSENTIAL = (1.0, 1.0, 0.0)
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _proper(U, Vt):
    """U with its last column, and Vt with its last row, multiplied by their
    determinants, so that both are rotations."""
    dU = _det3(U)[..., None, None]
    dV = _det3(Vt)[..., None, None]
    one = torch.ones_like(dU)
    U = U * torch.cat([one, one, dU], dim=-1)
    Vt = Vt * torch.cat([one, one, dV], dim=-2)
    return U, Vt


def essential_from_eight(x1, x2, weights=None):
    """Batched 8-point (or weighted N-point) essential matrix.

    Args:
      x1, x2: [..., N, 2] normalised coordinates in image 1 / image 2
        (N >= 8).
      weights: optional [..., N] non-negative weights (IRLS inlier masks).

    Returns E [..., 3, 3] with the essential constraint (two equal singular
    values, one zero) enforced.  Duplicate picks make A^T A rank-deficient:
    any vector of its null space is then returned, and the hypothesis still
    scores (finite), as in the JAX package.
    """
    h1 = _homog(x1.to(torch.float64))
    h2 = _homog(x2.to(torch.float64))
    # constraint rows: kron(h2, h1) so that row . vec(E) = h2^T E h1
    A = (h2[..., :, :, None] * h1[..., :, None, :]).reshape(
        x1.shape[:-1] + (9,))
    if weights is not None:
        A = A * weights[..., None].to(torch.float64)
    AtA = A.transpose(-1, -2) @ A                     # [..., 9, 9]
    e = smallest_eigenvector(AtA)
    E = e.reshape(e.shape[:-1] + (3, 3))
    # project to the essential manifold: singular values -> (1, 1, 0);
    # the third singular pair is dropped, so no det(U), det(V) fix
    U, _, Vt = svd3(E)
    S = const_table(_S_ESSENTIAL, E.dtype, E.device)
    return ((U * S) @ Vt).to(x1.dtype)


def sampson_error(E, x1, x2):
    """First-order geometric (Sampson) error of x2^T E x1 = 0.

    Args: E [..., 3, 3]; x1, x2 [..., N, 2].  Returns [..., N].
    """
    h1 = _homog(x1)
    h2 = _homog(x2)
    Ex1 = h1 @ E.transpose(-1, -2)          # [..., N, 3] = (E @ h1^T)^T
    Etx2 = h2 @ E                           # [..., N, 3] = (E^T @ h2^T)^T
    num = torch.sum(h2 * Ex1, dim=-1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num * num / torch.clamp(den, min=1e-12)


def decompose_essential(E):
    """E -> the four (R, t) candidates [(R1,t), (R1,-t), (R2,t), (R2,-t)].

    Returns (Rs [..., 4, 3, 3], ts [..., 4, 3]) with |t| = 1.
    """
    U, _, Vt = svd3(E)
    U, Vt = _proper(U, Vt)
    W = const_table(_W, E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def triangulate(R, t, x1, x2):
    """Linear (DLT) triangulation in the camera-1 frame.

    Args: (R, t) camera-2 pose (X2 = R X1 + t); x1, x2 [..., N, 2].
    Returns X [..., N, 3] and depths (z1, z2) [..., N].
    """
    batch = x1.shape[:-1]
    Rb = R[..., None, :, :].expand(batch + (3, 3))
    tb = t[..., None, :].expand(batch + (3,))
    r0, r1, r2 = Rb[..., 0, :], Rb[..., 1, :], Rb[..., 2, :]
    t0, t1, t2 = tb[..., 0], tb[..., 1], tb[..., 2]

    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    e0, e1, e2 = eye[0], eye[1], eye[2]
    # rows of x1 ^ (P1 X) and x2 ^ (P2 X), P1 = [I | 0], P2 = [R | t]
    A = torch.stack([
        x1[..., 0, None] * e2 - e0,
        x1[..., 1, None] * e2 - e1,
        x2[..., 0, None] * r2 - r0,
        x2[..., 1, None] * r2 - r1,
    ], dim=-2)                                        # [..., 4, 3]
    zero = torch.zeros_like(t0)
    b = torch.stack([zero, zero, t0 - x2[..., 0] * t2,
                     t1 - x2[..., 1] * t2], dim=-1)   # [..., 4]
    At = A.transpose(-1, -2)
    AtA = At @ A
    Atb = (At @ b[..., None])[..., 0]
    # 3x3 solve with a ridge for degenerate rays; errors stay on the device
    X = torch.linalg.solve_ex(AtA + 1e-9 * eye, Atb[..., None],
                              check_errors=False).result[..., 0]
    z1 = X[..., 2]
    z2 = (Rb @ X[..., None])[..., 0][..., 2] + t2
    return X, z1, z2


def recover_pose(E, x1, x2, mask=None):
    """The (R, t) candidate with the most points in front of both cameras
    (cheirality), like cv::recoverPose; ties go to the first candidate.

    Args: E [3, 3]; x1, x2 [N, 2]; mask optional [N] bool.
    Returns (R [3, 3], t [3], good [N] bool front-of-both mask).
    """
    Rs, ts = decompose_essential(E)                   # [4, 3, 3], [4, 3]
    n = x1.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x1.device)
    _, z1, z2 = triangulate(Rs, ts, x1.expand(4, n, 2), x2.expand(4, n, 2))
    oks = (z1 > 0) & (z2 > 0) & mask                  # [4, N]
    best = torch.argmax(oks.sum(dim=1)).view(1)       # first maximum
    return (Rs.index_select(0, best)[0], ts.index_select(0, best)[0],
            oks.index_select(0, best)[0])
