"""Sparse bundle adjustment with a matrix-free Schur complement.

Port of ``akaze_tpu/slam/ba.py``.  C camera poses (R [C, 3, 3], t [C, 3],
world -> camera), P landmarks X [P, 3] and M observations (cam [M], pt [M],
uv [M, 2] in normalised camera coordinates, weight w [M]).

The points are marginalised: CG runs on the reduced camera system
S = U - W V^-1 W^T without assembling it,

    S x = U x + lam x - W (V + lam)^-1 (W^T x),

where W^T x (by point) and W y (by camera) are segment sums over the
observation list (``linalg.segment_sum``, repeatable on the card).
Jacobians are closed forms; residuals are the pinhole reprojection
r = Xc[:2] / Xc[2] - uv.  The Levenberg-Marquardt loop runs a fixed number
of steps with its accept test and damping on the device.  The sharded
solver of the JAX package waits for the port of ``parallel/``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import hat, se3_compose, se3_exp
from .linalg import cg, one_hot, segment_sum


class BAProblem(NamedTuple):
    """Statically shaped BA problem (unused observations have w = 0)."""
    cam: torch.Tensor    # [M] int32 camera index per observation
    pt: torch.Tensor     # [M] int32 point index per observation
    uv: torch.Tensor     # [M, 2] normalised image coordinates
    w: torch.Tensor      # [M] float32 observation weight (0 = padding)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)


def _project(R, t, X):
    """Xc = R X + t; returns (pred [..., 2], Xc)."""
    Xc = (R @ X[..., None])[..., 0] + t
    return Xc[..., :2] / _safe_z(Xc[..., 2:3]), Xc


def ba_residuals(R, t, X, prob: BAProblem):
    """[M, 2] weighted reprojection residuals."""
    cam, pt = prob.cam.long(), prob.pt.long()
    pred, _ = _project(R[cam], t[cam], X[pt])
    return (pred - prob.uv) * prob.w[:, None]


def ba_cost(R, t, X, prob: BAProblem):
    r = ba_residuals(R, t, X, prob)
    return 0.5 * torch.sum(r * r)


def _obs_jacobians(R, t, X, prob: BAProblem):
    """Closed-form per-observation Jacobians.

    The camera update is right-multiplicative, T <- T exp([v, w]), so
    d Xc / d(v, w) = [R, -R [X]_x]; the point derivative is R.

    Returns (r [M, 2], Jc [M, 2, 6], Jp [M, 2, 3]).
    """
    cam, pt = prob.cam.long(), prob.pt.long()
    Rc = R[cam]
    Xp = X[pt]
    pred, Xc = _project(Rc, t[cam], Xp)
    w = prob.w
    r = (pred - prob.uv) * w[:, None]

    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / _safe_z(Xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    dproj = torch.stack([
        torch.stack([iz, zero, -x * iz2], dim=-1),
        torch.stack([zero, iz, -y * iz2], dim=-1),
    ], dim=-2) * w[:, None, None]                 # d(pred)/d(Xc) [M, 2, 3]

    Jc = torch.cat([dproj @ Rc, dproj @ (-Rc @ hat(Xp))], dim=-1)
    Jp = dproj @ Rc
    return r, Jc, Jp


def _matvec(J, x):
    """Batched matrix-vector product: [..., a, b] @ [..., b] -> [..., a]."""
    return (J @ x[..., None])[..., 0]


def _schur_solve(r, Jc, Jp, prob: BAProblem, hc, hp, lam, cg_iters: int):
    """One damped Gauss-Newton step via matrix-free Schur CG; ``hc``,
    ``hp``: the one-hot matrices of ``prob.cam`` and ``prob.pt``.

    Returns (dc [C, 6], dp [P, 3])."""
    cam, pt = prob.cam.long(), prob.pt.long()
    JcT = Jc.transpose(-1, -2)
    JpT = Jp.transpose(-1, -2)

    # block diagonals and gradient
    U = segment_sum(JcT @ Jc, hc)                         # [C, 6, 6]
    V = segment_sum(JpT @ Jp, hp)                         # [P, 3, 3]
    bc = segment_sum(_matvec(JcT, r), hc)                 # [C, 6]
    bp = segment_sum(_matvec(JpT, r), hp)                 # [P, 3]

    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = torch.linalg.inv_ex(V + lam * eye3).inverse    # [P, 3, 3]

    def W_T_x(x):
        """W^T x: [C, 6] -> [P, 3] via the observations."""
        return segment_sum(_matvec(JpT, _matvec(Jc, x[cam])), hp)

    def W_y(y):
        """W y: [P, 3] -> [C, 6] via the observations."""
        return segment_sum(_matvec(JcT, _matvec(Jp, y[pt])), hc)

    def S_matvec(x):
        return _matvec(U, x) + lam * x - W_y(_matvec(Vinv, W_T_x(x)))

    rhs = -bc + W_y(_matvec(Vinv, bp))
    dc = cg(S_matvec, rhs, cg_iters)
    dp = _matvec(Vinv, -bp - W_T_x(dc))
    return dc, dp


def bundle_adjust(R, t, X, prob: BAProblem, n_cams: int, n_pts: int,
                  iters: int = 8, cg_iters: int = 30, lam0: float = 1e-3,
                  fixed_cam_mask=None):
    """Levenberg-Marquardt sparse BA.

    Args:
      R, t: camera poses [C, 3, 3], [C, 3] (world -> camera).
      X: landmarks [P, 3].
      prob: observation list.
      n_cams, n_pts: sizes (== C, P).
      iters: LM iterations.
      cg_iters: CG iterations per Schur solve.
      lam0: initial LM damping.
      fixed_cam_mask: [C] bool gauge fixing (default: camera 0 fixed).

    Returns (R, t, X, final_cost), the cost a device scalar.
    """
    if fixed_cam_mask is None:
        fixed_cam_mask = torch.zeros(n_cams, dtype=torch.bool,
                                     device=R.device)
        fixed_cam_mask[0] = True
    free = (~fixed_cam_mask).to(R.dtype)[:, None]
    free_obs = free[prob.cam.long()][:, None, :]          # [M, 1, 1]
    hc = one_hot(prob.cam, n_cams, R.dtype)
    hp = one_hot(prob.pt, n_pts, R.dtype)
    lam = torch.full((), lam0, dtype=torch.float32, device=R.device)
    for _ in range(iters):
        r, Jc, Jp = _obs_jacobians(R, t, X, prob)
        dc, dp = _schur_solve(r, Jc * free_obs, Jp, prob, hc, hp, lam,
                              cg_iters)
        dR, dt = se3_exp(dc * free)
        R2, t2 = se3_compose(R, t, dR, dt)
        X2 = X + dp
        better = ba_cost(R2, t2, X2, prob) < ba_cost(R, t, X, prob)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
        X = torch.where(better, X2, X)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
    return R, t, X, ba_cost(R, t, X, prob)
