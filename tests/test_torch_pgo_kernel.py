"""PGO's kernel (``ops/pgo.py``, ``csrc/pgo.cu``, its SE(3) arithmetic
``csrc/se3.cuh``) against its plain twin, ``slam.posegraph.gauss_newton``
with one graph.

The CPU tests hold the wrapper's plain path bit for bit against
``gauss_newton`` (and ``optimize_pose_graph`` on the CPU), the wrapper's
argument checks, and the kernel's own arithmetic, compiled for the host by
the C++ compiler, against ``_edge_blocks``, ``_pair_residuals`` and
``_retract`` in every branch of ``so3_log`` (to rounding: the kernel sums
in the card's orders).  The tests marked ``cuda`` need an NVIDIA GPU and
skip elsewhere; they hold the kernel to the plain twin run on the same
card bit for bit (poses and cost), on seeded graphs of 8 to 256 poses and
8 to 1024 edges under every loss, drifted and with outlier loops, and on
the graphs a pass of the ``slam.tum.480x640`` cell builds; they check that
it repeats bit for bit and launches once a ``SlamSystem.optimize``.  This file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_pgo_kernel.py
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
from akaze_tpu_torch.ops import pgo
from akaze_tpu_torch.slam import posegraph as pg

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "akaze_tpu_torch" / "csrc"
LOSSES = [("none", 2.0), ("huber", 2.0), ("cauchy", 10.0)]
# (poses, edges) capacities: the SLAM route's buckets up to a full TUM
# sequence's ~160 keyframes and their loops
SIZES = [(8, 8), (16, 32), (32, 64), (64, 256), (256, 1024)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _poses(xi):
    """A chain of poses, each the last one times exp(xi[k])."""
    R, t = [torch.eye(3)], [torch.zeros(3)]
    for x in xi:
        dR, dt = se3_exp(x[None])
        Rn, tn = se3_compose(R[-1], t[-1], dR[0], dt[0])
        R.append(Rn)
        t.append(tn)
    return torch.stack(R), torch.stack(t)


def random_graph(seed, kcap, ecap):
    """A seeded pose graph padded as ``SlamSystem.optimize`` pads it: a
    trajectory of up to ``kcap`` poses, its odometry chain, loop edges
    between random pairs (one in eight of them a gross outlier), weights
    in [0.5, 2]; the initial poses drifted by noise
    accumulated along the chain; identity pads, gauge-fixed, and weight-0
    pad edges.  Returns (R, t, PoseGraph, fixed), float32 on the CPU."""
    rng = np.random.default_rng(seed)
    n_edges = ecap - int(rng.integers(0, max(1, ecap // 4)))
    k = min(kcap - int(rng.integers(0, max(1, kcap // 4))), n_edges + 1)
    step = rng.standard_normal((k - 1, 6)).astype(np.float32) * np.float32(
        [0.5] * 3 + [0.15] * 3)
    R_true, t_true = _poses(torch.from_numpy(step))
    ei = list(range(k - 1))
    ej = list(range(1, k))
    while len(ei) < n_edges:
        a, b = sorted(rng.integers(0, k, 2).tolist())
        if b - a > 1:
            ei.append(a)
            ej.append(b)
    Ri, ti = se3_inverse(R_true[ei], t_true[ei])
    Rij, tij = se3_compose(Ri, ti, R_true[ej], t_true[ej])
    noise = rng.standard_normal((n_edges, 6)).astype(np.float32) * 0.01
    if n_edges > k:
        bad = rng.choice(np.arange(k - 1, n_edges),
                         size=max(1, (n_edges - k + 1) // 8), replace=False)
        noise[bad] = rng.standard_normal((len(bad), 6)) * np.float32(
            [1.0] * 3 + [0.5] * 3)
    Rij, tij = se3_compose(Rij, tij, *se3_exp(torch.from_numpy(noise)))
    drift = rng.standard_normal((k - 1, 6)).astype(np.float32) * 0.03
    R0, t0 = _poses(torch.from_numpy(step + drift))
    R = torch.eye(3).repeat(kcap, 1, 1)
    t = torch.zeros(kcap, 3)
    R[:k], t[:k] = R0, t0
    fixed = torch.zeros(kcap, dtype=torch.bool)
    fixed[0] = True
    fixed[k:] = True
    gi = torch.zeros(ecap, dtype=torch.int32)
    gj = torch.zeros(ecap, dtype=torch.int32)
    gi[:n_edges] = torch.tensor(ei, dtype=torch.int32)
    gj[:n_edges] = torch.tensor(ej, dtype=torch.int32)
    GR = torch.eye(3).repeat(ecap, 1, 1)
    Gt = torch.zeros(ecap, 3)
    GR[:n_edges], Gt[:n_edges] = Rij, tij
    w = torch.zeros(ecap)
    w[:n_edges] = torch.from_numpy(rng.uniform(0.5, 2.0, n_edges)
                                   .astype(np.float32))
    return R, t, pg.PoseGraph(gi, gj, GR, Gt, w), fixed


def _to(dev, R, t, g, fixed):
    return R.to(dev), t.to(dev), pg.PoseGraph(*(a.to(dev) for a in g)), \
        fixed.to(dev)


def _damping(dev):
    # what programs.py hands the function: a float32 0-d tensor
    return torch.full((), 1e-6, dtype=torch.float32, device=dev)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("robust,delta", LOSSES)
def test_wrapper_on_cpu_is_gauss_newton(robust, delta):
    R, t, g, fixed = random_graph(1, 16, 32)
    got = pgo.pgo_solve(R, t, g, fixed, 10, 50, _damping("cpu"), robust,
                        delta)
    want = pg.gauss_newton(R, t, [g], fixed, 10, 50, _damping("cpu"), robust,
                           delta, reduce=pg._only, gather=pg._only)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float((got[0] - R).abs().max()) > 1e-3     # it moved the poses


def test_optimize_pose_graph_on_cpu_is_unchanged():
    """The program on CPU tensors runs the plain loop as before: the
    default gauge (pose 0 fixed) and a given mask, a float damping."""
    R, t, g, fixed = random_graph(2, 8, 16)
    launches = pgo.pgo_solve.launches
    for mask in (None, fixed):
        got = pg.optimize_pose_graph(R, t, g, iters=6, damping=1e-4,
                                     fixed_mask=mask, robust="cauchy",
                                     robust_delta=10.0)
        m = torch.arange(8) == 0 if mask is None else mask
        want = pg.gauss_newton(R, t, [g], m, 6, 50, 1e-4, "cauchy", 10.0,
                               reduce=pg._only, gather=pg._only)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert pgo.pgo_solve.launches == launches


def test_wrapper_checks_its_inputs():
    R, t, g, fixed = random_graph(3, 8, 8)
    d = _damping("cpu")

    def call(R=R, t=t, g=g, fixed=fixed, d=d):
        return pgo.pgo_solve(R, t, g, fixed, 2, 5, d, "none", 2.0)

    with pytest.raises(TypeError, match="R must be torch.float32"):
        call(R=R.double())
    with pytest.raises(TypeError, match="graph.i must be torch.int32"):
        call(g=g._replace(i=g.i.long()))
    with pytest.raises(TypeError, match="fixed_mask must be torch.bool"):
        call(fixed=fixed.int())
    with pytest.raises(TypeError, match="damping must be torch.float32"):
        call(d=d.double())
    with pytest.raises(ValueError, match="t has shape"):
        call(t=t[:4])
    with pytest.raises(ValueError, match="graph.R_ij has shape"):
        call(g=g._replace(R_ij=g.R_ij[:, :2]))
    with pytest.raises(ValueError, match="graph.i has shape"):
        call(g=g._replace(i=g.i[:5]))
    with pytest.raises(ValueError, match="fixed_mask is on meta"):
        call(fixed=fixed.to("meta"))
    with pytest.raises(ValueError, match="no pgo_solve kernel for device"):
        pgo.pgo_solve(*_to("meta", R, t, g, fixed), 2, 5,
                      d.to("meta"), "none", 2.0)
    call(R=R.transpose(1, 2).contiguous().transpose(1, 2))  # CPU: any stride


# The kernel's arithmetic (csrc/se3.cuh) built for the host: per edge the
# residual and the 12 derivative columns, and the retraction of poses.
HOST_SHIM = r"""
#include "se3.cuh"
extern "C" void edges(int E, const float* R, const float* t, const int* ei,
                      const int* ej, const float* Rij, const float* tij,
                      const float* w, float* J, float* res) {
  const int pat = se3::gemv_t(E);
  for (int e = 0; e < E; ++e) {
    float Rm[9], tm[3];
    se3::inverse(Rij + 9 * e, tij + 3 * e, Rm, tm, pat);
    const int i = ei[e], j = ej[e];
    se3::pair_residual(R + 9 * i, t + 3 * i, R + 9 * j, t + 3 * j, Rm, tm,
                       w[e], res + 6 * e, pat, pat);
    for (int col = 0; col < 12; ++col) {
      float c[6];
      se3::edge_column(R + 9 * i, t + 3 * i, R + 9 * j, t + 3 * j, Rm,
                       tij + 3 * e, w[e], col, E, c);
      for (int k = 0; k < 6; ++k) J[72 * e + 12 * k + col] = c[k];
    }
  }
}
extern "C" void retract(int N, const float* R, const float* t,
                        const float* dx, float* R2, float* t2) {
  for (int n = 0; n < N; ++n)
    se3::retract(R + 9 * n, t + 3 * n, dx + 6 * n, R2 + 9 * n, t2 + 3 * n);
}
"""


@pytest.fixture(scope="module")
def host_se3(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("se3")
    (out / "shim.cpp").write_text(HOST_SHIM)
    lib = out / "libse3.so"
    # -ffp-contract=off: separately rounded products and sums, as the
    # library's --fmad=false
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{CSRC}", "-o", str(lib), str(out / "shim.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("regime", ["small", "regular", "near_pi"])
def test_kernel_arithmetic_equals_edge_blocks(host_se3, regime):
    """Residuals and derivative blocks of the kernel's dual numbers against
    ``_edge_blocks`` (forward-mode AD) and ``_pair_residuals``, each edge's
    residual rotation in one regime of ``so3_log``: near 0 (below
    1e-2 rad, and exactly 0), regular, and 0.010-0.0135 rad from pi."""
    rng = np.random.default_rng(7)
    E = 48
    # axes away from the coordinate planes: near pi the tangent of the
    # axis' square root is ill-conditioned where a component nears 0
    axis = rng.uniform(0.3, 1.0, (E, 3)) * rng.choice([-1, 1], (E, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"small": rng.uniform(0.0, 5e-3, E),
             "regular": rng.uniform(0.05, 3.0, E),
             "near_pi": np.pi - rng.uniform(0.010, 0.0135, E)}[regime]
    if regime == "small":
        angle[:4] = 0.0
    err = np.zeros((E, 6), np.float32)
    err[:, 3:] = axis * angle[:, None]
    err[:, :3] = rng.standard_normal((E, 3)) * (0.0 if regime == "small"
                                                 else 1.0)
    Ra, ta = se3_exp(torch.from_numpy(
        rng.standard_normal((E, 6)).astype(np.float32)))
    Rb, tb = se3_exp(torch.from_numpy(
        rng.standard_normal((E, 6)).astype(np.float32)))
    # the measurement that leaves the residual rotation exp(err)
    Re, te = se3_exp(torch.from_numpy(err))
    Rrel, trel = se3_compose(*se3_inverse(Ra, ta), Rb, tb)
    Rij, tij = se3_compose(Rrel, trel, *se3_inverse(Re, te))
    R = torch.cat([Ra, Rb]).numpy()
    t = torch.cat([ta, tb]).numpy()
    ei = np.arange(E, dtype=np.int32)
    ej = ei + E
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    Rij, tij = Rij.numpy().copy(), tij.numpy().copy()
    J = np.zeros((E, 6, 12), np.float32)
    res = np.zeros((E, 6), np.float32)
    host_se3.edges(E, _ptr(R), _ptr(t), _ptr(ei), _ptr(ej), _ptr(Rij),
                   _ptr(tij), _ptr(w), _ptr(J), _ptr(res))

    args = (Ra, ta, Rb, tb, torch.from_numpy(Rij), torch.from_numpy(tij),
            torch.from_numpy(w))
    Ji, Jj = pg._edge_blocks(*args)
    want = torch.cat([Ji, Jj], -1).numpy()
    r = pg._pair_residuals(*args).numpy()
    assert np.isfinite(want).all()
    # the kernel's sums run in the card's cuBLAS and reduction orders,
    # the CPU's in its own: they agree to rounding, which near pi acos
    # amplifies (its slope 1 / sin(theta) is ~100 there)
    tol = 1e-3 if regime == "near_pi" else 1e-5
    assert np.abs(J - want).max() <= tol * np.abs(want).max()
    assert np.abs(res - r).max() <= tol / 10 * max(np.abs(r).max(), 1.0)
    theta = np.linalg.norm(r[:, 3:] / w[:, None], axis=1)
    lo, hi = {"small": (0.0, 1e-2), "regular": (1e-2, np.pi - 0.0142),
              "near_pi": (np.pi - 0.0142, np.pi)}[regime]
    assert ((theta >= lo - 1e-4) & (theta <= hi + 1e-4)).all()

    dx = rng.standard_normal((2 * E, 6)).astype(np.float32)
    dx[::3, 3:] *= 1e-3                          # small-angle steps too
    R2, t2 = np.zeros_like(R), np.zeros_like(t)
    host_se3.retract(2 * E, _ptr(R), _ptr(t), _ptr(dx), _ptr(R2), _ptr(t2))
    Rw, tw = pg._retract(torch.from_numpy(R), torch.from_numpy(t),
                         torch.from_numpy(dx))
    assert np.abs(R2 - Rw.numpy()).max() <= 1e-5
    assert np.abs(t2 - tw.numpy()).max() <= 1e-5 * np.abs(tw.numpy()).max()


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def rotation_rad(Ra, Rb):
    """Angle of Ra^T Rb per pose, in float64."""
    Rr = Ra.double().transpose(1, 2) @ Rb.double()
    c = ((Rr.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2).clamp(-1, 1)
    s = torch.linalg.vector_norm(Rr - Rr.transpose(1, 2), dim=(1, 2)) / (
        2 * np.sqrt(2))
    return torch.atan2(s, c)


def assert_equal_to_plain(got, want):
    """Bit for bit: the kernel runs every sum in the order of the plain
    loop's PyTorch operations on the card (csrc/pgo.cu)."""
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.cuda
@pytest.mark.parametrize("robust,delta", LOSSES, ids=[x for x, _ in LOSSES])
@pytest.mark.parametrize("kcap,ecap", SIZES,
                         ids=[f"{k}x{e}" for k, e in SIZES])
def test_kernel_equals_plain(cuda, kcap, ecap, robust, delta):
    for seed in (kcap + ecap, kcap * ecap + 1):
        R, t, g, fixed = _to(cuda, *random_graph(seed, kcap, ecap))
        args = (R, t, g, fixed, 10, 50, _damping(cuda), robust, delta)
        before = pgo.pgo_solve.launches
        got = pgo.pgo_solve(*args)
        assert pgo.pgo_solve.launches == before + 1
        assert_equal_to_plain(got, pgo.pgo_solve_plain(*args))
        assert float(rotation_rad(got[0], R).max()) > 1e-3   # poses moved


@pytest.mark.cuda
@pytest.mark.parametrize("robust,delta", LOSSES, ids=[x for x, _ in LOSSES])
def test_kernel_repeats_bit_for_bit(cuda, robust, delta):
    for kcap, ecap in ((16, 32), (256, 1024)):
        R, t, g, fixed = _to(cuda, *random_graph(5, kcap, ecap))
        args = (R, t, g, fixed, 10, 50, _damping(cuda), robust, delta)
        first, second = pgo.pgo_solve(*args), pgo.pgo_solve(*args)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_handles_edges_that_name_no_pose(cuda):
    """An edge index outside [0, N) reads no memory out of bounds and makes
    the cost NaN; iters 0 returns the poses and their cost."""
    R, t, g, fixed = _to(cuda, *random_graph(6, 8, 8))
    d = _damping(cuda)
    R0, t0, c0 = pgo.pgo_solve(R, t, g, fixed, 0, 50, d, "none", 2.0)
    assert torch.equal(R0, R) and torch.equal(t0, t)
    assert torch.equal(c0, pg.pose_graph_cost(R, t, g))
    j = g.j.clone()
    j[0] = 99
    bad = g._replace(j=j)
    assert torch.isnan(pgo.pgo_solve(R, t, bad, fixed, 2, 5, d, "none",
                                     2.0)[2])


def tum_pass_graphs(device):
    """Each ``optimize_pose_graph`` call of one pass of the
    ``slam.tum.480x640`` cell (its configuration, route and world 0) with
    the ``pgo_solve`` launches of each ``SlamSystem.optimize``."""
    from akaze_tpu_torch import AkazeConfig
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    from akaze_tpu_torch.slam import system as slam_system
    from cardbench import gen
    bench = ROOT / "cardbench"
    config = json.loads((bench / "configs" / "slam-tum-rgbd-480x640.json")
                        .read_text())
    mix = json.loads((bench / "traffic" / "tum-route59.json").read_text())
    frames, _ = gen.route_frames(*config["image"], mix["out_frames"],
                                 mix["step_px"], mix["blob_density"], 0,
                                 device)
    system = SlamSystem(Intrinsics(**config["intrinsics"]),
                        AkazeConfig(**config["akaze"]),
                        SlamConfig(**config["slam"]), device=device,
                        **config["vo"])
    calls, launches = [], []
    solve, optimize = slam_system.optimize_pose_graph, system.optimize

    def recorded(R, t, graph, **kw):
        calls.append(((R.clone(), t.clone(),
                       pg.PoseGraph(*(a.clone() for a in graph))), kw))
        return solve(R, t, graph, **kw)

    def counted(*a, **kw):
        before = pgo.pgo_solve.launches
        out = optimize(*a, **kw)
        launches.append(pgo.pgo_solve.launches - before)
        return out

    system.optimize = counted
    slam_system.optimize_pose_graph = recorded
    try:
        for f in frames.cpu().numpy():
            system.process(f)
    finally:
        slam_system.optimize_pose_graph = solve
    return calls, launches


@pytest.mark.cuda
def test_tum_pass_graphs_equal_plain_and_launch_once(cuda):
    calls, launches = tum_pass_graphs(cuda)
    assert calls and launches == [1] * len(calls)
    for (R, t, g), kw in calls:
        assert R.shape[0] >= 8 and g.weight.shape[0] >= 8
        args = (R, t, g, kw["fixed_mask"], kw.get("iters", 10), 50,
                _damping(cuda), kw["robust"], kw["robust_delta"])
        assert_equal_to_plain(pgo.pgo_solve(*args),
                              pgo.pgo_solve_plain(*args))
