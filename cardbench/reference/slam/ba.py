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
of steps with its accept test and damping on the device.  The Schur step
(``schur_solve_shards``) takes the observations as per-shard pieces with a
camera-side and a point-side reduction, so that ``parallel/sharded_ba.py``
runs it with observations or landmark blocks sharded over a mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .se3 import hat, se3_compose, se3_exp
from .solvers import cg, one_hot, segment_sum


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
    dc, dp = schur_solve_shards([r], [Jc], [Jp], [prob], [hc], [hp], lam,
                                cg_iters, cam_reduce=lambda xs: xs[0],
                                pt_reduce=lambda xs: xs)
    return dc, dp[0]


def schur_solve_shards(r, Jc, Jp, probs, hc, hp, lam, cg_iters: int,
                       cam_reduce, pt_reduce):
    """The Schur step over observations split into shards: every argument
    but ``lam`` and ``cg_iters`` is a list with one entry per shard, on the
    shard's device (the JAX package's ``_schur_solve`` under
    ``shard_map``).

    ``cam_reduce(list)``: the sum of per-shard camera-side quantities
    ([C, ...]), once, on the cameras' device (the JAX ``psum_axis``).
    ``pt_reduce(list)``: per-shard point-side quantities ([P, ...]) as
    each shard's point block: summed and handed to every shard when the
    shards share the landmarks, or left as they are when each shard owns
    its landmarks and all their observations (the JAX ``local_points``).

    Returns (dc [C, 6] on the cameras' device, [dp [P_s, 3]] per shard)."""
    lam_s = [lam.to(x.device) for x in r]
    cams = [p.cam.long() for p in probs]
    pts = [p.pt.long() for p in probs]
    JcT = [J.transpose(-1, -2) for J in Jc]
    JpT = [J.transpose(-1, -2) for J in Jp]

    # block diagonals and gradient
    U = cam_reduce([segment_sum(a @ b, h)
                    for a, b, h in zip(JcT, Jc, hc)])             # [C, 6, 6]
    V = pt_reduce([segment_sum(a @ b, h)
                   for a, b, h in zip(JpT, Jp, hp)])              # [P, 3, 3]
    bc = cam_reduce([segment_sum(_matvec(a, x), h)
                     for a, x, h in zip(JcT, r, hc)])             # [C, 6]
    bp = pt_reduce([segment_sum(_matvec(a, x), h)
                    for a, x, h in zip(JpT, r, hp)])              # [P, 3]

    eye3 = torch.eye(3, dtype=V[0].dtype, device=V[0].device)
    Vinv = [torch.linalg.inv_ex(v + lm * eye3.to(v.device)).inverse
            for v, lm in zip(V, lam_s)]                           # [P, 3, 3]

    def W_T_x(x):
        """W^T x: [C, 6] -> [P, 3] via the observations."""
        return pt_reduce([
            segment_sum(_matvec(a, _matvec(b, x.to(a.device)[c])), h)
            for a, b, c, h in zip(JpT, Jc, cams, hp)])

    def W_y(ys):
        """W y: [P, 3] -> [C, 6] via the observations."""
        return cam_reduce([segment_sum(_matvec(a, _matvec(b, y[p])), h)
                           for a, b, y, p, h in zip(JcT, Jp, ys, pts, hc)])

    def S_matvec(x):
        return _matvec(U, x) + lam * x - W_y(
            [_matvec(vi, w) for vi, w in zip(Vinv, W_T_x(x))])

    rhs = -bc + W_y([_matvec(vi, b) for vi, b in zip(Vinv, bp)])
    dc = cg(S_matvec, rhs, cg_iters)
    dp = [_matvec(vi, -b - w) for vi, b, w in zip(Vinv, bp, W_T_x(dc))]
    return dc, dp


def bundle_adjust(R, t, X, prob: BAProblem, n_cams: int, n_pts: int,
                  iters: int = 8, cg_iters: int = 30, lam0: float = 1e-3,
                  fixed_cam_mask=None):
    """Levenberg-Marquardt sparse BA, a compiled program
    (``programs.py``): one CUDA graph per (static arguments, tensor
    shapes) on the card; ``lam0`` is traced, an input of the graph.

    Args:
      R, t: camera poses [C, 3, 3], [C, 3] (world -> camera).
      X: landmarks [P, 3].
      prob: observation list.
      n_cams, n_pts: sizes (== C, P).
      iters: LM iterations.
      cg_iters: CG iterations per Schur solve.
      lam0: initial LM damping (a number; the function sees it as a 0-d
        tensor, as ``programs.py`` passes every traced number).
      fixed_cam_mask: [C] bool gauge fixing (default: camera 0 fixed).

    Returns (R, t, X, final_cost), the cost a device scalar.
    """
    if fixed_cam_mask is None:      # (an item assignment would copy)
        fixed_cam_mask = torch.arange(n_cams, device=R.device) == 0
    free = (~fixed_cam_mask).to(R.dtype)[:, None]
    free_obs = free[prob.cam.long()][:, None, :]          # [M, 1, 1]
    hc = one_hot(prob.cam, n_cams, R.dtype)
    hp = one_hot(prob.pt, n_pts, R.dtype)
    lam = torch.as_tensor(lam0, device=R.device).to(torch.float32)
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
