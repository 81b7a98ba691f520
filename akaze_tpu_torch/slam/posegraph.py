"""Pose-graph optimisation (PGO) on SE(3), matrix-free Gauss-Newton.

Port of ``akaze_tpu/slam/posegraph.py``.  N poses (R [N, 3, 3], t [N, 3])
and E relative-pose edges (i, j, measured T_ij, scalar weight); the
residual of an edge is

    r_e = w_e * log( T_ij^-1 * T_i^-1 * T_j )   in se(3), [6].

The JAX package differentiates the whole residual vector with
``jax.linearize`` and transposes it.  Here ``torch.func`` gives each edge's
two 6x6 derivative blocks (d r_e / d xi_i and d r_e / d xi_j at xi = 0,
forward-mode AD over all edges at once) once per Gauss-Newton step; J v is then
a gather and two batched products, and J^T u a segment sum over the nodes.
The normal matrix is never assembled, and (J^T J + damping) dx = -J^T r is
solved with conjugate gradients.  Pose 0 (or ``fixed_mask``) is held by
zeroing its update.  The loop (``gauss_newton``) takes the edge list as
per-shard pieces with a sum and a gather over them, so that
``parallel/sharded_pgo.py`` runs it with the edges sharded over a mesh.
On the card ``optimize_pose_graph`` runs the whole loop as one kernel
(``ops/pgo.py``), whose plain twin is ``gauss_newton`` with one graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry.se3 import se3_compose, se3_exp, se3_inverse, se3_log
from ..ops.pgo import pgo_solve
from ..programs import jit
from .linalg import cg, one_hot, segment_sum


class PoseGraph(NamedTuple):
    """Edge-list pose graph (statically shaped; unused edge slots have
    weight 0)."""
    i: torch.Tensor       # [E] int32 source node
    j: torch.Tensor       # [E] int32 target node
    R_ij: torch.Tensor    # [E, 3, 3] measured relative rotation
    t_ij: torch.Tensor    # [E, 3] measured relative translation
    weight: torch.Tensor  # [E] float32 (sqrt information scalar; 0 = off)


def _retract(R, t, xi):
    """Right-multiplicative manifold update: T <- T * exp(xi)."""
    dR, dt = se3_exp(xi)
    return se3_compose(R, t, dR, dt)


def _pair_residuals(Ri, ti, Rj, tj, R_ij, t_ij, weight):
    """Residuals of edges given the poses at their ends."""
    Rinv, tinv = se3_inverse(Ri, ti)
    Rrel, trel = se3_compose(Rinv, tinv, Rj, tj)           # T_i^-1 T_j
    Rm_inv, tm_inv = se3_inverse(R_ij, t_ij)
    Re, te = se3_compose(Rm_inv, tm_inv, Rrel, trel)       # T_ij^-1 ...
    return se3_log(Re, te) * weight[..., None]


def _edge_residuals(R, t, g: PoseGraph):
    i, j = g.i.long(), g.j.long()
    return _pair_residuals(R[i], t[i], R[j], t[j], g.R_ij, g.t_ij, g.weight)


def pose_graph_cost(R, t, g: PoseGraph):
    r = _edge_residuals(R, t, g)
    return 0.5 * torch.sum(r * r)


def _masked_median(x, mask):
    """Median of x over mask=True entries (lower median; 0 if none)."""
    s, _ = torch.sort(torch.where(mask, x, torch.full_like(x, torch.inf)))
    cnt = mask.sum()
    idx = torch.clamp(cnt - 1, min=0) // 2
    return torch.where(cnt > 0, s.gather(0, idx.view(1))[0],
                       torch.zeros_like(s[0]))


def _robust_delta(norms, active, delta_scale: float):
    """The IRLS threshold: ``delta_scale`` times the median residual norm
    over the active edges."""
    return torch.clamp(delta_scale * _masked_median(norms, active),
                       min=1e-12)


def _irls_weights(norms, delta, kind: str = "huber"):
    """Per-edge IRLS sqrt-weights of edges with residual norms ``norms``.
    ``huber``: weight min(1, delta/n), whose influence saturates;
    ``cauchy``: weight 1/(1 + (n/delta)^2), which redescends and so rejects
    gross outliers (see the JAX module for the measurements behind the
    choice)."""
    if kind == "cauchy":
        q = norms / delta
        return torch.sqrt(1.0 / (1.0 + q * q))
    return torch.sqrt(torch.clamp(delta / torch.clamp(norms, min=1e-12),
                                  max=1.0))


def _huber_irls_weights(r, active, delta_scale: float = 2.0,
                        kind: str = "huber"):
    """Per-edge IRLS sqrt-weights for a self-tuning robust loss.

    ``r`` [E, 6]: current (information-weighted) edge residuals.  The
    threshold is delta = delta_scale * median residual norm over the
    active edges, re-estimated each Gauss-Newton step (``_irls_weights``).
    """
    n = torch.sqrt(torch.sum(r * r, dim=-1))
    return _irls_weights(n, _robust_delta(n, active, delta_scale), kind)


def _edge_blocks(Ri, ti, Rj, tj, R_ij, t_ij, weight):
    """Derivative blocks (d r_e / d xi_i, d r_e / d xi_j), each [E, 6, 6],
    of every edge's residual at xi = 0, by forward-mode AD: the edges are
    repeated once per basis direction of (xi_i, xi_j), and one pass of
    dual numbers gives all 12 columns.  The primals keep their edge axis
    (PyTorch's forward-mode AD gives float64 tangents for 0-dim float32
    tensors combined with Python scalars)."""
    E = weight.shape[0]
    basis = torch.eye(12, dtype=Ri.dtype, device=Ri.device)[:, None, :]
    basis = basis.expand(12, E, 12)
    zero = torch.zeros_like(basis)

    def rep(a):
        return a.expand((12,) + tuple(a.shape))

    with fwAD.dual_level():
        xi = fwAD.make_dual(zero, basis)
        Ri2, ti2 = _retract(rep(Ri), rep(ti), xi[..., :6])
        Rj2, tj2 = _retract(rep(Rj), rep(tj), xi[..., 6:])
        r = _pair_residuals(Ri2, ti2, Rj2, tj2, rep(R_ij), rep(t_ij),
                            rep(weight))
        J = fwAD.unpack_dual(r).tangent.permute(1, 2, 0)    # [E, 6, 12]
    return J[..., :6], J[..., 6:]


@jit(static_argnames=("iters", "cg_iters", "robust", "robust_delta"))
def optimize_pose_graph(R, t, graph: PoseGraph, iters: int = 10,
                        cg_iters: int = 50, damping: float = 1e-6,
                        fixed_mask=None, robust: str = "none",
                        robust_delta: float = 2.0):
    """Gauss-Newton PGO, a compiled program (``programs.py``): one CUDA
    graph per (static arguments, tensor shapes) on the card, whose one
    node is the ``pgo_solve`` kernel (``ops/pgo.py``; CPU tensors run
    ``gauss_newton``); ``damping`` is traced, an input of the graph.

    Args:
      R, t: initial poses [N, 3, 3], [N, 3].
      graph: edge constraints.
      iters: outer Gauss-Newton iterations.
      cg_iters: CG iterations per Gauss-Newton step.
      damping: Levenberg lambda added to the normal matrix diagonal.
      fixed_mask: [N] bool, True for gauge-fixed poses (default: pose 0).
      robust: "none" (least squares), "huber" or "cauchy" (IRLS with a
        self-tuning threshold, ``_huber_irls_weights``).

    Returns (R, t, final_cost), the cost a device scalar.  A step is kept
    only where it lowers the (IRLS-weighted) cost, decided on the device.
    """
    if fixed_mask is None:          # (an item assignment would copy)
        fixed_mask = torch.arange(R.shape[0], device=R.device) == 0
    return pgo_solve(R, t, graph, fixed_mask, iters, cg_iters, damping,
                     robust, robust_delta)


def _only(xs):
    return xs[0]


class _Shard(NamedTuple):
    """One shard's edges and what the loop derives from them once."""
    graph: PoseGraph
    dev: torch.device
    i: torch.Tensor       # [E] int64 source node
    j: torch.Tensor       # [E] int64 target node
    hot_i: torch.Tensor   # [E, N] one-hot of i
    hot_j: torch.Tensor   # [E, N] one-hot of j
    free: torch.Tensor    # [N, 1] 1 for a free pose, 0 for a fixed one


def gauss_newton(R, t, graphs, fixed_mask, iters: int, cg_iters: int,
                 damping: float, robust: str, robust_delta: float,
                 reduce, gather):
    """The Gauss-Newton loop over an edge list split into ``graphs``, one
    per shard, each on its shard's device (one graph on one device for
    ``optimize_pose_graph``; ``parallel.sharded_pgo`` shards it).

    Poses live once, on ``R``'s device.  ``reduce(list)``: the sum over
    the shards of per-shard tensors, on that device (J^T J v, J^T r and
    the costs); ``gather(list)``: their concatenation there (the edge
    norms whose median sets the robust threshold, which is global)."""
    n = R.shape[0]
    free = (~fixed_mask).to(R.dtype)[:, None]
    shards = []
    for g in graphs:
        d = g.weight.device
        i, j = g.i.long(), g.j.long()
        shards.append(_Shard(g, d, i, j, one_hot(i, n, R.dtype),
                             one_hot(j, n, R.dtype), free.to(d)))

    def cost_h(R, t, hs):
        def one(s, h):
            r = _edge_residuals(R.to(s.dev), t.to(s.dev), s.graph) * h[:, None]
            return 0.5 * torch.sum(r * r)
        return reduce([one(s, h) for s, h in zip(shards, hs)])

    def jt(s, Ji, Jj, u):
        """J^T u of one shard, [N, 6]: u [E, 6] per edge."""
        u = u[..., None]
        return (segment_sum((Ji.transpose(1, 2) @ u)[..., 0], s.hot_i)
                + segment_sum((Jj.transpose(1, 2) @ u)[..., 0], s.hot_j))

    for _ in range(iters):
        rs = [_edge_residuals(R.to(s.dev), t.to(s.dev), s.graph)
              for s in shards]
        if robust in ("huber", "cauchy"):
            norms = [torch.sqrt(torch.sum(r * r, dim=-1)) for r in rs]
            delta = _robust_delta(gather(norms),
                                  gather([s.graph.weight > 0
                                          for s in shards]),
                                  robust_delta)
            hs = [_irls_weights(nrm, delta.to(s.dev), robust)
                  for nrm, s in zip(norms, shards)]
        else:
            hs = [torch.ones_like(s.graph.weight) for s in shards]
        # derivative blocks of r_e * h_e in the free updates xi * free
        blocks = []
        for s, h in zip(shards, hs):
            Rd, td, g = R.to(s.dev), t.to(s.dev), s.graph
            Ji, Jj = _edge_blocks(Rd[s.i], td[s.i], Rd[s.j], td[s.j],
                                  g.R_ij, g.t_ij, g.weight)
            blocks.append((Ji * (h[:, None] * s.free[s.i])[..., None],
                           Jj * (h[:, None] * s.free[s.j])[..., None]))

        def matvec(v):
            parts = []
            for s, (Ji, Jj) in zip(shards, blocks):
                vd = v.to(s.dev)
                u = Ji @ vd[s.i][..., None] + Jj @ vd[s.j][..., None]
                parts.append(jt(s, Ji, Jj, u[..., 0]))
            return reduce(parts) + damping * v

        g = reduce([jt(s, Ji, Jj, r * h[:, None])
                    for s, (Ji, Jj), r, h in zip(shards, blocks, rs, hs)])
        dx = cg(matvec, -g, cg_iters) * free
        R2, t2 = _retract(R, t, dx)
        better = cost_h(R2, t2, hs) < cost_h(R, t, hs)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
    return R, t, reduce([pose_graph_cost(R.to(s.dev), t.to(s.dev), s.graph)
                         for s in shards])
