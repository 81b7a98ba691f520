"""Pose-graph optimisation in one kernel: the whole Gauss-Newton / CG loop
of ``slam.posegraph.gauss_newton`` for one graph on one device.

The CUDA kernel is ``csrc/pgo.cu`` (its SE(3) arithmetic
``csrc/se3.cuh``).  It replaces no TPU kernel; its header says why it was
added and what bounds it on the card.

``pgo_solve`` is the wrapper: on CUDA tensors it launches the kernel (one
launch a call) or raises, on CPU tensors it runs ``pgo_solve_plain``,
which is ``gauss_newton`` with one graph.  Both return the optimised poses
and the final cost.  ``parallel/sharded_pgo.py`` keeps the plain loop: its
sums cross devices in every CG step.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# the kernel's robust losses (csrc/pgo.cu Robust); any other name is least
# squares, as in gauss_newton
ROBUST = {"huber": 1, "cauchy": 2}


def pgo_solve_plain(R, t, graph, fixed_mask, iters: int, cg_iters: int,
                    damping, robust: str, robust_delta: float):
    """The plain PyTorch version; same arguments and results as
    ``pgo_solve``."""
    from ..slam.posegraph import _only, gauss_newton   # it imports this
    return gauss_newton(R, t, [graph], fixed_mask, iters, cg_iters, damping,
                        robust, robust_delta, reduce=_only, gather=_only)


def _check(R, t, graph, fixed_mask, damping, contiguous: bool):
    n, e = R.shape[0], graph.weight.shape[0]
    dev = R.device
    for name, x, dtype, shape in (
            ("R", R, torch.float32, (n, 3, 3)),
            ("t", t, torch.float32, (n, 3)),
            ("graph.i", graph.i, torch.int32, (e,)),
            ("graph.j", graph.j, torch.int32, (e,)),
            ("graph.R_ij", graph.R_ij, torch.float32, (e, 3, 3)),
            ("graph.t_ij", graph.t_ij, torch.float32, (e, 3)),
            ("graph.weight", graph.weight, torch.float32, (e,)),
            ("fixed_mask", fixed_mask, torch.bool, (n,))):
        _build.check_tensor(name, x, dtype, shape, dev, contiguous)
    if isinstance(damping, torch.Tensor):
        _build.check_tensor("damping", damping, torch.float32, (), dev)


def _launch(R, t, graph, fixed_mask, iters, cg_iters, damping, robust,
            robust_delta):
    n, e = R.shape[0], graph.weight.shape[0]
    dev = R.device
    if not isinstance(damping, torch.Tensor):
        damping = torch.full((), damping, dtype=torch.float32, device=dev)
    lib = _build.library()
    need = ctypes.c_longlong(0)
    _build.check(lib.akaze_pgo_scratch(n, e, ctypes.byref(need)),
                 "pgo_solve_kernel")
    scratch = (torch.empty(need.value, dtype=torch.float32, device=dev)
               if need.value else None)
    R_out = torch.empty_like(R)
    t_out = torch.empty_like(t)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.akaze_pgo_solve(
            R.data_ptr(), t.data_ptr(), graph.i.data_ptr(),
            graph.j.data_ptr(), graph.R_ij.data_ptr(), graph.t_ij.data_ptr(),
            graph.weight.data_ptr(), fixed_mask.data_ptr(),
            damping.data_ptr(), n, e, iters, cg_iters,
            ROBUST.get(robust, 0), robust_delta, R_out.data_ptr(),
            t_out.data_ptr(), cost.data_ptr(), _build.ptr(scratch),
            need.value, _build.stream_of(R), ctypes.byref(launched))
    _build.check(err, "pgo_solve_kernel")
    pgo_solve.launches += launched.value
    return R_out, t_out, cost


def pgo_solve(R, t, graph, fixed_mask, iters: int, cg_iters: int, damping,
              robust: str, robust_delta: float):
    """Gauss-Newton PGO of one pose graph, as ``gauss_newton`` computes it.

    Args:
      R, t: initial poses [N, 3, 3], [N, 3] (float32).
      graph: ``slam.posegraph.PoseGraph`` of E edges (int32 ends, float32
        measurements and weights; weight 0 = no edge).
      fixed_mask: [N] bool, True for gauge-fixed poses.
      iters, cg_iters: Gauss-Newton and CG steps.
      damping: Levenberg lambda, a number or a float32 0-d tensor on the
        poses' device (what ``programs`` hands a traced number as).
      robust, robust_delta: the IRLS loss ("none", "huber", "cauchy") and
        its threshold in residual medians.

    Returns (R, t, cost): the poses, of which a step is kept only where it
    lowers the (IRLS-weighted) cost, and the final unweighted cost, a 0-d
    tensor.  On the card the kernel's sums run in another order than the
    plain version's, so the two agree to rounding.
    """
    dev = R.device
    _check(R, t, graph, fixed_mask, damping, dev.type == "cuda")
    if dev.type == "cpu":
        return pgo_solve_plain(R, t, graph, fixed_mask, iters, cg_iters,
                               damping, robust, robust_delta)
    if dev.type == "cuda":
        return _launch(R, t, graph, fixed_mask, iters, cg_iters, damping,
                       robust, robust_delta)
    raise ValueError(f"no pgo_solve kernel for device {dev}")


# kernel launches; a replayed program adds the launches its capture
# recorded (programs.py), so the count covers graphs too
pgo_solve.launches = 0
