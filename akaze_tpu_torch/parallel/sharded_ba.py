"""Distributed bundle adjustment: observations or landmark blocks sharded
over a mesh.

Port of ``akaze_tpu/parallel/sharded_ba.py``.  Keyframes stay replicated
(camera state is tiny, [C, 6]; kept once per process, on the mesh's first
device); observations, the bulk of the problem, are split across the
shards.  The Levenberg-Marquardt loop is the single-device one, with the
Schur step's reductions (``slam.ba.schur_solve_shards``) summed over the
shards in a fixed order:

* ``sharded_bundle_adjust`` shards observations arbitrarily: camera-side
  and point-side sums ([C, 6] and [P, 3]) both cross the mesh;
* ``landmark_sharded_bundle_adjust`` places each landmark with all its
  observations on one shard (``partition_landmarks``), so V, b_p, W^T x
  and the back-substitution stay local and each CG step sums one [C, 6]
  quantity over the mesh, whatever the landmark count.

Each is one compiled program (``_run_sharded_ba``,
``_run_landmark_sharded_ba``; JAX's static arguments, ``lam0`` among
them): one CUDA graph per key and process, over the process's cards of
the mesh, its sums across processes inside it on NCCL
(``programs.mesh_route``).  The partition (``partition_landmarks``,
``gather_points``) and the sharding of the inputs run on the host before
the program, as JAX's partition does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import se3_compose, se3_exp
from ..programs import jit
from ..slam.ba import BAProblem, _obs_jacobians, ba_cost, schur_solve_shards
from ..slam.linalg import one_hot
from . import collectives as col
from .mesh import Mesh, axis_size, normalize_axes


def pad_observations(prob: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation list to a multiple (weight-0 padding rows)."""
    m = prob.cam.shape[0]
    rem = (-m) % multiple
    if rem == 0:
        return prob
    return BAProblem(*(torch.cat([f, f.new_zeros((rem,) + f.shape[1:])])
                       for f in prob))


def _shard_problem(prob, mesh: Mesh, axis) -> list:
    if isinstance(prob, BAProblem):
        if prob.cam.shape[0] % axis_size(mesh, axis):
            raise ValueError("pad the observations to a multiple of the "
                             "axis size first (pad_observations)")
        return [BAProblem(*fs) for fs in zip(
            *(col.shard(f, mesh, axis) for f in prob))]
    return list(prob)


def _gauge(R, fixed_cam_mask, home):
    """``fixed_cam_mask`` on ``home``; by default camera 0 fixed (made
    without an item assignment, which would copy from the host)."""
    if fixed_cam_mask is None:
        return torch.arange(R.shape[0], device=home) == 0
    return fixed_cam_mask.to(home)


def _lm(R, t, Xs, probs, mesh: Mesh, axis, fixed_cam_mask, n_pts, iters,
        cg_iters, lam0, local_points: bool):
    """The LM loop of ``slam.bundle_adjust`` over observation shards.
    ``Xs``: each shard's landmark block (the whole map, replicated, unless
    ``local_points``); R, t and ``fixed_cam_mask`` on the mesh's first
    device."""
    n_cams = R.shape[0]
    free = (~fixed_cam_mask).to(R.dtype)[:, None]
    devs = [p.cam.device for p in probs]
    free_obs = [free.to(d)[p.cam.long()][:, None, :]
                for d, p in zip(devs, probs)]
    hc = [one_hot(p.cam, n_cams, R.dtype) for p in probs]
    hp = [one_hot(p.pt, x.shape[0] if local_points else n_pts, R.dtype)
          for p, x in zip(probs, Xs)]

    def cam_reduce(xs):
        return col.psum_home(xs, mesh, axis)

    def pt_reduce(xs):
        return xs if local_points else col.psum(xs, mesh, axis)

    def cost(R, t, Xs):
        return cam_reduce([ba_cost(R.to(d), t.to(d), x, p)
                           for d, x, p in zip(devs, Xs, probs)])

    lam = torch.full((), lam0, dtype=torch.float32, device=R.device)
    for _ in range(iters):
        Rs = [R.to(d) for d in devs]
        ts = [t.to(d) for d in devs]
        jac = [_obs_jacobians(Rd, td, x, p)
               for Rd, td, x, p in zip(Rs, ts, Xs, probs)]
        dc, dp = schur_solve_shards(
            [j[0] for j in jac], [j[1] * f for j, f in zip(jac, free_obs)],
            [j[2] for j in jac], probs, hc, hp, lam, cg_iters,
            cam_reduce, pt_reduce)
        dR, dt = se3_exp(dc * free)
        R2, t2 = se3_compose(R, t, dR, dt)
        X2 = [x + d for x, d in zip(Xs, dp)]
        better = cost(R2, t2, X2) < cost(R, t, Xs)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
        Xs = [torch.where(better.to(x.device), x2, x)
              for x, x2 in zip(Xs, X2)]
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
    return R, t, Xs, cost(R, t, Xs)


def sharded_bundle_adjust(R, t, X, prob, mesh: Mesh, iters: int = 8,
                          cg_iters: int = 30, lam0: float = 1e-3,
                          axis="data", fixed_cam_mask=None):
    """LM bundle adjustment with observations sharded over ``mesh[axis]``.

    Args mirror ``slam.bundle_adjust``; ``prob`` must be padded to a
    multiple of the axis size (``pad_observations``), or be a list of
    per-shard problems.  ``axis`` may be one axis name or an
    innermost-first hierarchy such as ``("chip", "host")``.  Returns
    (R, t, X, final_cost) on the mesh's first device."""
    axis = normalize_axes(axis)
    home = mesh.home
    return _run_sharded_ba(R.to(home), t.to(home), X.to(home),
                           _shard_problem(prob, mesh, axis),
                           _gauge(R, fixed_cam_mask, home), mesh=mesh,
                           iters=iters, cg_iters=cg_iters, lam0=lam0,
                           axis=axis)


@jit(static_argnames=("mesh", "iters", "cg_iters", "lam0", "axis"),
     collective_axes=lambda statics: statics["axis"])
def _run_sharded_ba(R, t, X, prob, fixed_cam_mask, *, mesh, iters,
                    cg_iters, lam0, axis):
    """``_lm`` over the observation shards ``prob`` with the map ``X``
    replicated; everything else on the mesh's first device."""
    R, t, Xs, c = _lm(R, t, col.replicate(X, mesh), prob, mesh, axis,
                      fixed_cam_mask, X.shape[0], iters, cg_iters, lam0,
                      local_points=False)
    return R, t, Xs[0].to(mesh.home), c


class LandmarkPartition(NamedTuple):
    """Host-side plan placing each landmark (and all its observations) on
    one shard, so that every point-side quantity of the Schur solve is
    local.

    Arrays are laid out shard-major: shard d owns points
    [d*pts_per_shard, (d+1)*pts_per_shard) and observations
    [d*obs_per_shard, (d+1)*obs_per_shard).  ``prob.pt`` holds LOCAL point
    indices; ``prob.cam`` stays global (cameras are replicated).
    ``point_perm`` maps partitioned point rows back to the original
    landmark order (-1 = padding row).  ``prob`` holds CPU tensors."""
    prob: BAProblem
    point_perm: np.ndarray   # [n_shards * pts_per_shard] int32
    pts_per_shard: int
    obs_per_shard: int


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def partition_landmarks(prob: BAProblem, n_pts: int, n_shards: int,
                        min_pts_per_shard: int = 0,
                        min_obs_per_shard: int = 0) -> LandmarkPartition:
    """Partition landmarks (and their observations) into ``n_shards``
    blocks, exactly as the JAX package does.

    Greedy balancing: points go to the shard with the fewest observations
    so far, in decreasing-observation-count order.  Padding observations
    carry weight 0 and reference local point 0 of their shard.
    ``min_pts_per_shard``/``min_obs_per_shard`` floor the per-shard
    capacities so that callers can bucket them; both round up to a
    multiple of 8."""
    cam, pt, uv, w = (_numpy(f) for f in prob)
    live = w > 0
    counts = np.bincount(pt[live], minlength=n_pts)

    order = np.argsort(-counts, kind="stable")
    shard_of = np.empty(n_pts, np.int32)
    shard_sizes = np.zeros(n_shards, np.int64)
    shard_pts: list = [[] for _ in range(n_shards)]
    for p in order:
        d = int(np.argmin(shard_sizes))
        shard_of[p] = d
        shard_sizes[d] += max(int(counts[p]), 1)
        shard_pts[d].append(int(p))

    pts_per_shard = max(max(len(s) for s in shard_pts), min_pts_per_shard)
    pts_per_shard = pts_per_shard + (-pts_per_shard) % 8
    obs_dev = [np.nonzero(live & (shard_of[pt] == d))[0]
               for d in range(n_shards)]
    obs_per_shard = max(max(len(o) for o in obs_dev), min_obs_per_shard)
    obs_per_shard = obs_per_shard + (-obs_per_shard) % 8

    local_of = np.zeros(n_pts, np.int32)
    point_perm = np.full(n_shards * pts_per_shard, -1, np.int32)
    for d in range(n_shards):
        for li, p in enumerate(shard_pts[d]):
            local_of[p] = li
            point_perm[d * pts_per_shard + li] = p

    m = n_shards * obs_per_shard
    cam2 = np.zeros(m, np.int32)
    pt2 = np.zeros(m, np.int32)
    uv2 = np.zeros((m, 2), np.float32)
    w2 = np.zeros(m, np.float32)
    for d in range(n_shards):
        o = obs_dev[d]
        lo = d * obs_per_shard
        cam2[lo:lo + len(o)] = cam[o]
        pt2[lo:lo + len(o)] = local_of[pt[o]]
        uv2[lo:lo + len(o)] = uv[o]
        w2[lo:lo + len(o)] = w[o]

    prob2 = BAProblem(*(torch.from_numpy(a) for a in (cam2, pt2, uv2, w2)))
    return LandmarkPartition(prob2, point_perm, pts_per_shard,
                             obs_per_shard)


def gather_points(part: LandmarkPartition, X) -> torch.Tensor:
    """[n_pts, 3] landmarks -> shard-major [n_shards*pts_per_shard, 3]
    (a CPU tensor)."""
    Xp = np.zeros((len(part.point_perm), 3), np.float32)
    sel = part.point_perm >= 0
    Xp[sel] = _numpy(X)[part.point_perm[sel]]
    return torch.from_numpy(Xp)


def scatter_points(part: LandmarkPartition, Xp) -> np.ndarray:
    """Inverse of ``gather_points`` (padding rows dropped).  ``Xp``: the
    shard-major tensor (``collectives.all_gather`` of the blocks, over the
    solver's axis, puts them in that order)."""
    n_pts = int(part.point_perm.max()) + 1
    X = np.zeros((n_pts, 3), np.float32)
    sel = part.point_perm >= 0
    X[part.point_perm[sel]] = _numpy(Xp)[sel]
    return X


def landmark_sharded_bundle_adjust(R, t, X, part: LandmarkPartition,
                                   mesh: Mesh, iters: int = 8,
                                   cg_iters: int = 30, lam0: float = 1e-3,
                                   axis="data", fixed_cam_mask=None):
    """LM bundle adjustment with LANDMARKS sharded over ``mesh[axis]``.

    Each shard owns a block of landmarks and all their observations, so
    each CG step sums one [C, 6] quantity over the mesh
    (``collectives.traced`` shows it).  ``X``: the shard-major landmark
    tensor from ``gather_points``, or its per-shard blocks.  ``axis`` may
    be an axis name or an innermost-first tuple such as ``("chip",
    "host")``.  Returns (R, t, X_blocks, final_cost): R, t and the cost on
    the mesh's first device, X_blocks one [pts_per_shard, 3] block per
    local shard in mesh order (``collectives.all_gather`` over ``axis``
    orders them by block for ``scatter_points``)."""
    axis = normalize_axes(axis)
    n = axis_size(mesh, axis)
    if isinstance(X, torch.Tensor):
        if X.shape[0] != n * part.pts_per_shard:
            raise ValueError("X must come from gather_points with the same "
                             "shard count")
        Xs = col.shard(X, mesh, axis)
    else:
        Xs = list(X)
    home = mesh.home
    return _run_landmark_sharded_ba(
        R.to(home), t.to(home), Xs, _shard_problem(part.prob, mesh, axis),
        _gauge(R, fixed_cam_mask, home), mesh=mesh, iters=iters,
        cg_iters=cg_iters, lam0=lam0, axis=axis)


@jit(static_argnames=("mesh", "iters", "cg_iters", "lam0", "axis"),
     collective_axes=lambda statics: statics["axis"])
def _run_landmark_sharded_ba(R, t, X, prob, fixed_cam_mask, *, mesh, iters,
                             cg_iters, lam0, axis):
    """``_lm`` over the landmark blocks ``X`` and their observations
    ``prob``, one of each per local shard."""
    return _lm(R, t, X, prob, mesh, axis, fixed_cam_mask, None, iters,
               cg_iters, lam0, local_points=True)
