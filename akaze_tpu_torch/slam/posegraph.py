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
zeroing its update.  The edge-sharded solver of the JAX package waits for
the port of ``parallel/``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry.se3 import se3_compose, se3_exp, se3_inverse, se3_log
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


def _huber_irls_weights(r, active, delta_scale: float = 2.0,
                        kind: str = "huber"):
    """Per-edge IRLS sqrt-weights for a self-tuning robust loss.

    ``r`` [E, 6]: current (information-weighted) edge residuals.  The
    threshold is delta = delta_scale * median residual norm over the
    active edges, re-estimated each Gauss-Newton step.  ``huber``: weight
    min(1, delta/n), whose influence saturates; ``cauchy``: weight
    1/(1 + (n/delta)^2), which redescends and so rejects gross outliers
    (see the JAX module for the measurements behind the choice).
    """
    n = torch.sqrt(torch.sum(r * r, dim=-1))
    delta = torch.clamp(delta_scale * _masked_median(n, active), min=1e-12)
    if kind == "cauchy":
        q = n / delta
        return torch.sqrt(1.0 / (1.0 + q * q))
    return torch.sqrt(torch.clamp(delta / torch.clamp(n, min=1e-12),
                                  max=1.0))


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


def optimize_pose_graph(R, t, graph: PoseGraph, iters: int = 10,
                        cg_iters: int = 50, damping: float = 1e-6,
                        fixed_mask=None, robust: str = "none",
                        robust_delta: float = 2.0):
    """Gauss-Newton PGO.

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
    n = R.shape[0]
    if fixed_mask is None:
        fixed_mask = torch.zeros(n, dtype=torch.bool, device=R.device)
        fixed_mask[0] = True
    free = (~fixed_mask).to(R.dtype)[:, None]
    active = graph.weight > 0
    i, j = graph.i.long(), graph.j.long()
    hot_i = one_hot(i, n, R.dtype)
    hot_j = one_hot(j, n, R.dtype)

    def cost_h(R, t, h):
        r = _edge_residuals(R, t, graph) * h[:, None]
        return 0.5 * torch.sum(r * r)

    for _ in range(iters):
        r = _edge_residuals(R, t, graph)
        if robust in ("huber", "cauchy"):
            h = _huber_irls_weights(r, active, robust_delta, robust)
        else:
            h = torch.ones_like(graph.weight)
        # derivative blocks of r_e * h_e in the free updates xi * free
        Ji, Jj = _edge_blocks(R[i], t[i], R[j], t[j], graph.R_ij,
                              graph.t_ij, graph.weight)
        Ji = Ji * (h[:, None] * free[i])[..., None]
        Jj = Jj * (h[:, None] * free[j])[..., None]
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)

        def jvp(v):
            return (Ji @ v[i][..., None] + Jj @ v[j][..., None])[..., 0]

        def vjp(u):
            u = u[..., None]
            return (segment_sum((JiT @ u)[..., 0], hot_i)
                    + segment_sum((JjT @ u)[..., 0], hot_j))

        def matvec(v):
            return vjp(jvp(v)) + damping * v

        g = vjp(r * h[:, None])
        dx = cg(matvec, -g, cg_iters) * free
        R2, t2 = _retract(R, t, dx)
        better = cost_h(R2, t2, h) < cost_h(R, t, h)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
    return R, t, pose_graph_cost(R, t, graph)
