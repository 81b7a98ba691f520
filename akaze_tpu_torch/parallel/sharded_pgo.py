"""Distributed pose-graph optimisation: edges sharded over a mesh.

Port of ``akaze_tpu/parallel/sharded_pgo.py``.  The pose state (tiny,
[N, 3, 3] + [N, 3]) is kept once per process, on the mesh's first device;
the edge list, the bulk of a large pose graph, is split across the shards.
Each shard builds the derivative blocks of its own edges
(``slam.posegraph.gauss_newton``); every CG matvec sums the shards' [N, 6]
J^T J v, and the gradient J^T r the same way, in a fixed order
(``collectives.psum_home``).  The robust losses need the GLOBAL median of
the edge residual norms ([E] floats), so the norms are all-gathered.

The solve is one compiled program (``_run_sharded_pgo``, JAX's static
arguments: ``damping`` is static here, traced in the single-device
``optimize_pose_graph``, as in the JAX package): one CUDA graph per key
on a mesh whose shards share one card, or lie on several cards of this
process (``programs.mesh_route``).
"""

from __future__ import annotations

import torch

from ..programs import jit
from ..slam.posegraph import PoseGraph, gauss_newton
from . import collectives as col
from .mesh import Mesh, axis_size, normalize_axes


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge list to a multiple (weight-0 self-edges at node 0)."""
    e = graph.i.shape[0]
    rem = (-e) % multiple
    if rem == 0:
        return graph
    dev = graph.weight.device
    eye = torch.eye(3, dtype=graph.R_ij.dtype, device=dev).expand(rem, 3, 3)

    def zeros(x, *shape):
        return torch.zeros((rem,) + shape, dtype=x.dtype, device=dev)

    return PoseGraph(
        i=torch.cat([graph.i, zeros(graph.i)]),
        j=torch.cat([graph.j, zeros(graph.j)]),
        R_ij=torch.cat([graph.R_ij, eye]),
        t_ij=torch.cat([graph.t_ij, zeros(graph.t_ij, 3)]),
        weight=torch.cat([graph.weight, zeros(graph.weight)]))


def sharded_optimize_pose_graph(R, t, graph: PoseGraph, mesh: Mesh,
                                iters: int = 10, cg_iters: int = 50,
                                damping: float = 1e-6, axis="data",
                                fixed_mask=None, robust: str = "none",
                                robust_delta: float = 2.0):
    """Gauss-Newton PGO with the edge list sharded over ``mesh[axis]``.

    Args mirror ``slam.optimize_pose_graph``; ``graph`` must be padded to a
    multiple of the axis size (``pad_edges``), or be a list of per-shard
    edge lists.  ``axis`` may be one axis name or an innermost-first
    hierarchy such as ``("chip", "host")``.  Returns (R, t, final_cost) on
    the mesh's first device."""
    axis = normalize_axes(axis)
    home = mesh.home
    if isinstance(graph, PoseGraph):
        if graph.i.shape[0] % axis_size(mesh, axis):
            raise ValueError("pad the edges to a multiple of the axis size "
                             "first (pad_edges)")
        parts = [col.shard(f, mesh, axis) for f in graph]
        graphs = [PoseGraph(*fs) for fs in zip(*parts)]
    else:
        graphs = list(graph)
    if fixed_mask is None:          # (an item assignment would copy)
        fixed_mask = torch.arange(R.shape[0], device=home) == 0
    return _run_sharded_pgo(R.to(home), t.to(home), graphs,
                            fixed_mask.to(home), mesh=mesh, iters=iters,
                            cg_iters=cg_iters, damping=damping, axis=axis,
                            robust=robust, robust_delta=robust_delta)


@jit(static_argnames=("mesh", "iters", "cg_iters", "damping", "axis",
                      "robust", "robust_delta"),
     collective_axes=lambda statics: statics["axis"])
def _run_sharded_pgo(R, t, graph, fixed_mask, *, mesh, iters, cg_iters,
                     damping, axis, robust="none", robust_delta=2.0):
    """The Gauss-Newton loop over ``graph``, one edge list per local
    shard; R, t and ``fixed_mask`` on the mesh's first device."""
    return gauss_newton(
        R, t, graph, fixed_mask, iters, cg_iters, damping, robust,
        robust_delta,
        reduce=lambda xs: col.psum_home(xs, mesh, axis),
        gather=lambda xs: col.all_gather(xs, mesh, axis, home_only=True))
