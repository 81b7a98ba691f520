"""The port's compiled programs (``akaze_tpu_torch.programs``) against the
JAX package's ``jax.jit`` sites, on the CPU.

On the CPU a program runs its function as it is (nothing is captured), so
these tests hold what the CPU can show: the programs declare JAX's static
arguments, their cache keys follow JAX's retracing rule, traced scalars
reach the solvers as arguments, and loop-candidate scoring equals JAX's.
Captured graphs are held against eager runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: ``_batched_match_counts`` exactly; PGO poses within 5e-4 and
its cost within 1e-4 relative, BA rotations within 1e-4, translations
within 1e-3, points within 5e-3 and its cost within 1e-3 relative (the
bounds ``tests/test_torch_slam.py`` states for these solvers).
"""

import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.geometry import se3_compose as jcompose
from akaze_tpu.geometry import se3_exp as jexp
from akaze_tpu.slam import ba as jba
from akaze_tpu.slam import posegraph as jpg
from akaze_tpu.slam import system as jsys
from akaze_tpu_torch import Akaze, AkazeConfig, programs
from akaze_tpu_torch import pipeline as tpipe
from akaze_tpu_torch.geometry import homography as thom
from akaze_tpu_torch.geometry import ransac as transac
from akaze_tpu_torch.ops import describe as k2
from akaze_tpu_torch.ops import hamming as k4
from akaze_tpu_torch.ops import sublevel as k1
from akaze_tpu_torch.parallel import data_parallel as tdp
from akaze_tpu_torch.parallel import make_mesh
from akaze_tpu_torch.parallel import sharded_ba as tsba
from akaze_tpu_torch.parallel import sharded_pgo as tspgo
from akaze_tpu_torch.slam import ba as tba
from akaze_tpu_torch.slam import odometry as todo
from akaze_tpu_torch.slam import posegraph as tpg
from akaze_tpu_torch.slam import system as tsys
from test_slam import make_ba_problem
from test_torch_slam import pose_graph_problem, t_

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# each single-device jax.jit site of the JAX package and the port's program
SITES = [
    ("akaze_tpu/pipeline.py", "_jit_detect_and_compute_pair",
     tpipe._jit_detect_and_compute_pair),
    ("akaze_tpu/pipeline.py", "_jit_detect_and_compute",
     tpipe._jit_detect_and_compute),
    ("akaze_tpu/pipeline.py", "_jit_match", tpipe._jit_match),
    ("akaze_tpu/slam/system.py", "_batched_match_counts",
     tsys._batched_match_counts),
    ("akaze_tpu/slam/posegraph.py", "optimize_pose_graph",
     tpg.optimize_pose_graph),
    ("akaze_tpu/slam/ba.py", "bundle_adjust", tba.bundle_adjust),
    # the two-view sites: the draw runs eagerly before each program, so
    # the program is the solve on the drawn sets (and, for _two_view, the
    # triangulation after it)
    ("akaze_tpu/slam/odometry.py", "_two_view", todo._solve),
    ("akaze_tpu/geometry/ransac.py", "ransac_essential",
     transac._ransac_essential),
    ("akaze_tpu/geometry/homography.py", "ransac_homography",
     thom._ransac_homography),
    # the multi-device sites: a Mesh among the static values
    ("akaze_tpu/pipeline.py", "_jit_spatial_detect_and_compute",
     tpipe._jit_spatial_detect_and_compute),
    ("akaze_tpu/parallel/sharded_pgo.py", "_run_sharded_pgo",
     tspgo._run_sharded_pgo),
    ("akaze_tpu/parallel/sharded_ba.py", "_run_sharded_ba",
     tsba._run_sharded_ba),
    ("akaze_tpu/parallel/sharded_ba.py", "_run_landmark_sharded_ba",
     tsba._run_landmark_sharded_ba),
]


def jax_static_arguments(path: str, name: str):
    """(static_argnames, static_argnums) of the ``partial(jax.jit, ...)``
    decorator on function ``name`` of ``path``, read from the source."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            for dec in node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and ast.unparse(dec.func) == "partial"
                        and ast.unparse(dec.args[0]) == "jax.jit"):
                    kw = {k.arg: ast.literal_eval(k.value)
                          for k in dec.keywords}
                    return (tuple(kw.get("static_argnames", ())),
                            tuple(kw.get("static_argnums", ())))
    raise AssertionError(f"no jax.jit decorator on {path}:{name}")


@pytest.mark.parametrize("path,name,program", SITES,
                         ids=[s[1] for s in SITES])
def test_programs_declare_jax_static_arguments(path, name, program):
    names, nums = jax_static_arguments(path, name)
    assert isinstance(program, programs.Program)
    assert program.static_argnames == names
    assert program.static_argnums == nums
    params = list(program.signature.parameters)
    assert program.static == set(names) | {params[i] for i in nums}


def _words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("n_kf,max_dist", [(3, 96), (4, 96), (5, 60)])
def test_batched_match_counts_matches_jax(n_kf, max_dist):
    """Stacked words of ``n_kf`` keyframes: some rows copies of the query
    with a few flipped bits, the rest random; dead slots at the end."""
    rng = np.random.default_rng(n_kf)
    t = 96
    qw = _words(rng, t)
    qv = np.arange(t) < 80
    words = np.stack([_words(rng, t) for _ in range(n_kf)])
    valid = np.stack([np.arange(t) < 70 + 5 * c for c in range(n_kf)])
    for c in range(n_kf):
        rows = rng.choice(70, 10 + 10 * c, replace=False)
        flips = rng.integers(0, 32, (len(rows), 16))
        words[c, rows] = qw[rows] ^ (np.uint32(1) << flips.astype(np.uint32))
    want = np.asarray(jsys._batched_match_counts(
        jnp.asarray(qw), jnp.asarray(qv), jnp.asarray(words),
        jnp.asarray(valid), max_dist))
    got = tsys._batched_match_counts(
        t_(qw.view(np.int32)), t_(qv), t_(words.view(np.int32)), t_(valid),
        max_dist)
    assert got.dtype == torch.int32 and got.shape == (n_kf,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 10).all()


@pytest.mark.parametrize("damping", [1e-6, 1e-1])
def test_pose_graph_damping_is_traced(damping):
    rng = np.random.default_rng(5)
    R0, t0, graph, fixed = pose_graph_problem(rng)
    kw = dict(iters=6, robust="cauchy", robust_delta=10.0)
    Rj, tj, cj = jpg.optimize_pose_graph(
        jnp.asarray(R0), jnp.asarray(t0),
        jpg.PoseGraph(*(jnp.asarray(a) for a in graph)), damping=damping,
        fixed_mask=jnp.asarray(fixed), **kw)
    Rt, tt, ct = tpg.optimize_pose_graph(
        t_(R0), t_(t0), tpg.PoseGraph(*(t_(a) for a in graph)),
        damping=damping, fixed_mask=t_(fixed), **kw)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=5e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-4)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    key, leaves, _, _ = tpg.optimize_pose_graph.key(
        t_(R0), t_(t0), tpg.PoseGraph(*(t_(a) for a in graph)),
        damping=damping, fixed_mask=t_(fixed), **kw)
    assert [x for x in leaves if isinstance(x, float)] == [damping]
    assert ("scalar", "float") in key[2]


@pytest.mark.parametrize("lam0", [1e-3, 1.0])
def test_bundle_adjust_lam0_is_traced(lam0):
    rng = np.random.default_rng(7)
    R, t, X, prob = make_ba_problem(rng, noise=1e-3)
    n_cams, n_pts = R.shape[0], X.shape[0]
    dxi = rng.standard_normal((n_cams, 6)).astype(np.float32) * 0.02
    dxi[0] = 0.0
    dR, dt = jexp(jnp.asarray(dxi))
    R0, t0 = jax.vmap(jcompose)(R, t, dR, dt)
    X0 = X + jnp.asarray(rng.standard_normal(X.shape).astype(np.float32)
                         * 0.03)
    kw = dict(n_cams=n_cams, n_pts=n_pts, iters=6)
    out_j = jba.bundle_adjust(R0, t0, X0, prob, lam0=lam0, **kw)
    args = (*(t_(a) for a in (R0, t0, X0)),
            tba.BAProblem(*(t_(a) for a in prob)))
    # lam0 as a number, and as the 0-d tensor a program's input buffer
    # holds on the card
    for lam in (lam0, torch.tensor(lam0)):
        out_t = tba.bundle_adjust(*args, lam0=lam, **kw)
        for got, want, tol in zip(out_t[:3], out_j[:3], (1e-4, 1e-3, 5e-3)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol)
        np.testing.assert_allclose(float(out_t[3]), float(out_j[3]),
                                   rtol=1e-3, atol=1e-9)
    # lam0 is a traced leaf: its value is no part of the key, its kind is
    key, leaves, statics, _ = tba.bundle_adjust.key(*args, lam0=lam0, **kw)
    assert [x for x in leaves if isinstance(x, float)] == [lam0]
    assert ("scalar", "float") in key[2]
    assert "lam0" not in dict(statics)
    assert tba.bundle_adjust.key(*args, lam0=2 * lam0, **kw)[0] == key
    tkey = tba.bundle_adjust.key(*args, lam0=torch.tensor(lam0), **kw)[0]
    assert ("tensor", (), torch.float32, torch.device("cpu")) in tkey[2]
    assert tkey != key


def test_two_view_scalars_are_traced():
    """``fx``, ``fy``, ``cx``, ``cy`` and ``threshold`` are traced: their
    values are no part of the two programs' keys, and the 0-d tensors a
    program's input buffers hold give the numbers' results bit for bit.
    ``_two_view`` is ``_putative``, the draw, then ``_solve``."""
    from akaze_tpu_torch.geometry.ransac import make_key, sets_from_key
    from akaze_tpu_torch.io.dataset import projected_sequence
    frames, _ = projected_sequence(np.random.default_rng(5))
    f1, f2 = (tpipe.features_from_numpy(f, "cpu") for f in frames[:2])
    words = (f1.words, f1.valid, f1.x, f1.y, f2.words, f2.valid, f2.x, f2.y)
    intr = (500.0, 500.0, 320.0, 240.0)
    key, leaves, _, _ = todo._putative.key(*words, *intr)
    assert [x for x in leaves if isinstance(x, float)] == list(intr)
    assert todo._putative.key(*words, 400.0, 410.0, 300.0, 200.0)[0] == key
    m, x1, x2, put = todo._putative(*words, *intr)
    m_t, x1_t, x2_t, put_t = todo._putative(
        *words, *(torch.tensor(v) for v in intr))
    for a, b in zip((*m, x1, x2, put), (*m_t, x1_t, x2_t, put_t)):
        assert torch.equal(a, b)
    sets = sets_from_key(make_key(3), put, 512)
    res = todo._solve(x1, x2, put, sets, 2e-5, num_hyps=512)
    res_t = todo._solve(x1, x2, put, sets, torch.tensor(2e-5), num_hyps=512)
    for a, b in zip(torch.utils._pytree.tree_leaves(res),
                    torch.utils._pytree.tree_leaves(res_t)):
        assert torch.equal(a, b)
    skey, sleaves, statics, _ = todo._solve.key(x1, x2, put, sets, 2e-5,
                                                num_hyps=512)
    assert dict(statics) == {"num_hyps": 512}
    assert [x for x in sleaves if isinstance(x, float)] == [2e-5]
    assert todo._solve.key(x1, x2, put, sets, 1e-4, num_hyps=512)[0] == skey
    whole = todo._two_view(make_key(3), f1, f2, *intr, 2e-5)
    for a, b in zip(torch.utils._pytree.tree_leaves(whole),
                    torch.utils._pytree.tree_leaves((m, *res))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sets of shape"):
        todo._solve(x1, x2, put, sets[:100], 2e-5, num_hyps=512)


def test_keys_follow_static_values_shapes_and_none():
    prog = tpg.optimize_pose_graph
    R, t = torch.eye(3).repeat(4, 1, 1), torch.zeros(4, 3)
    g = tpg.PoseGraph(torch.zeros(8, dtype=torch.int32),
                      torch.ones(8, dtype=torch.int32),
                      torch.eye(3).repeat(8, 1, 1), torch.zeros(8, 3),
                      torch.ones(8))
    mask = torch.zeros(4, dtype=torch.bool)

    def key(*a, **kw):
        return prog.key(*a, **kw)[0]

    base = key(R, t, g, iters=5, fixed_mask=mask)
    # equal signatures, other values: one key (a traced scalar's value is
    # not part of it)
    assert key(R + 1, t, g, iters=5, fixed_mask=~mask, damping=0.5) == base
    assert key(R, t, g, 5, fixed_mask=mask) == base
    others = [
        key(R, t, g, iters=6, fixed_mask=mask),                 # static
        key(R, t, g, iters=5, fixed_mask=mask, robust="huber"),
        key(R.repeat(2, 1, 1), t.repeat(2, 1), g, iters=5,      # shape
            fixed_mask=mask.repeat(2)),
        key(R.double(), t, g, iters=5, fixed_mask=mask),        # dtype
        key(R, t, g, iters=5),                                  # None
        key(R, t, g, iters=5, fixed_mask=mask, damping=1),      # int
    ]
    assert len(set(others + [base])) == len(others) + 1
    with pytest.raises(TypeError):
        key(R, t, g, iters=5, fixed_mask="all")
    m = tpipe._jit_match
    w, v = torch.zeros(8, 16, dtype=torch.int32), torch.ones(8, dtype=bool)
    x = torch.zeros(8)
    assert m.key(w, v, w, v, x, x, 96)[0] != m.key(w, v, w, v, x, x, 60)[0]
    assert m.key(w, v, w, v, x, x, 96)[0] == m.key(w, v, w, v, x, x,
                                                   max_dist=96)[0]


def test_cpu_akaze_captures_nothing():
    """A CPU ``Akaze`` runs the functions as they are: no capture, no
    replay, the module functions' results, and the kernels' counters
    unmoved (the plain versions ran)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:104, 0:136].astype(np.float32)
    img = np.full((104, 136), 0.5, np.float32)
    for cy, cx, s, amp in zip(*(rng.uniform(lo, hi, 150) for lo, hi in (
            (0, 104), (0, 136), (2, 4), (-0.3, 0.3)))):
        img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img = np.clip(img, 0, 1).astype(np.float32)
    a, b = img[:96, :128].copy(), img[5:101, 7:135].copy()
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_top2)
    before = [fn.launches for fn in counters]
    det = Akaze(AkazeConfig(max_pts=256, noctaves=2, dthreshold=5e-5),
                device="cpu")
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    f1 = det.detect_and_compute(a, describe=False)
    plan = det.plan_for(96, 128)
    wa, wb = tpipe.detect_and_compute_pair(t_(a), t_(b), plan)
    for got, want in ((fa, wa), (fb, wb)):
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    assert torch.equal(m.index, tpipe.match(
        wa.words, wa.valid, wb.words, wb.valid, wb.x, wb.y).index)
    w1 = tpipe.detect_and_compute(t_(a), plan, describe=False)
    for g_, w_ in zip(f1, w1):
        assert torch.equal(g_, w_)
    for _, _, p in SITES:
        assert p.captures == 0 and p.replays == 0 and not p.entries
    assert [fn.launches for fn in counters] == before
    assert int(fa.count) > 0 and int((m.index >= 0).sum()) > 0


def test_eager_context_and_device_check():
    calls = []

    @programs.jit(static_argnames=("n",))
    def double(x, n):
        calls.append(n)
        return x * n

    x = torch.ones(3)
    with programs.eager():
        assert torch.equal(double(x, 2), 2 * x)
    assert torch.equal(double(x, n=3), 3 * x) and calls == [2, 3]
    assert double.captures == 0 and not double.entries
    with pytest.raises(TypeError):
        double.key(x, 2, 4)           # too many arguments for the signature
    with pytest.raises(ValueError):
        programs._program_device("double", [x, torch.ones(1, device="meta")])
    with pytest.raises(ValueError):
        programs.jit(double.fn, static_argnames=("m",))


@pytest.mark.parametrize("eager", [False, True])
def test_traced_numbers_reach_the_function_as_tensors(eager):
    """Every traced number reaches the function as a 0-d tensor of
    ``torch.as_tensor``'s dtype for it, on the call's device, as a
    captured call's input buffers hold it, on the CPU and under
    ``eager()`` alike; static numbers, tensors and None pass as they are."""
    seen = {}

    @programs.jit(static_argnames=("n",))
    def scaled(x, s, k, flag, none, n):
        seen.update(s=s, k=k, flag=flag, none=none, n=n)
        return x * s / n

    x = torch.ones(3)
    with programs.eager() if eager else contextlib.nullcontext():
        out = scaled(x, 0.1, 7, True, None, n=3)
    for name, dtype in (("s", torch.float32), ("k", torch.int64),
                        ("flag", torch.bool)):
        v = seen[name]
        assert isinstance(v, torch.Tensor) and v.dim() == 0
        assert v.dtype == dtype and v.device == x.device
    assert seen["s"].item() == torch.tensor(0.1).item()
    assert seen["k"].item() == 7 and seen["flag"].item() is True
    assert seen["none"] is None and seen["n"] == 3
    assert torch.equal(out, x * torch.tensor(0.1) / 3)
    assert scaled.captures == 0 and not scaled.entries


def test_dp_program_statics_are_make_dp_steps_closure():
    """JAX's dp step is ``jax.jit(local_step)``, a closure of
    ``make_dp_step``: its static values are the arguments of
    ``make_dp_step`` that ``local_step`` reads (decorator included), less
    the TPU knob ``match_pallas``, which is not ported.  The port's
    program declares exactly those, and ``make_dp_step`` calls it."""
    tree = ast.parse((ROOT / "akaze_tpu/parallel/data_parallel.py")
                     .read_text())
    outer = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                 and n.name == "make_dp_step")
    params = {a.arg for a in outer.args.args}
    inner = next(n for n in ast.walk(outer) if isinstance(n, ast.FunctionDef)
                 and n.name == "local_step")
    read = {n.id for n in ast.walk(inner) if isinstance(n, ast.Name)}
    assert (params & read) - {"match_pallas"} == {"plan", "mesh", "fixed"}
    prog = tdp._dp_step
    assert isinstance(prog, programs.Program)
    assert prog.static_argnames == ("plan", "mesh", "fixed")
    assert prog.collective_axes is None
    plan = tpipe.build_plan(64, 80, AkazeConfig(max_pts=64, noctaves=1))
    mesh = make_mesh(2, devices=["cpu"] * 2)
    step = tdp.make_dp_step(plan, mesh, fixed=True)
    assert step.func is prog
    assert step.keywords == dict(plan=plan, mesh=mesh, fixed=True)


def _process_mesh(monkeypatch, n=4, device="cuda:0",
                  backend="cpu:gloo,cuda:gloo", devices=None):
    """A mesh whose "data" axis spans two processes, built from device
    names alone (torch.distributed answering as process 0 of 2, its group
    on ``backend``)."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend_config",
                        lambda group=None: backend)
    return programs_mesh(devices or [device] * n, process_axis="data")


def programs_mesh(devices, axis_names=("data",), process_axis=None):
    from akaze_tpu_torch.parallel import Mesh
    return Mesh(np.asarray(devices, dtype=object), axis_names,
                process_axis=process_axis)


def test_mesh_capture_rule(monkeypatch):
    """The rule that decides, from a key alone, how a mesh program runs:
    shards on one card, or on several cards of a mesh of this process
    alone, are captured; a collective across processes on gloo, or tensors
    off the mesh's cards, run eagerly; CPU shards take the CPU path.  A
    program without collectives (the dp step) is captured on a process
    mesh whose local shards share a card."""
    cuda0 = torch.device("cuda", 0)
    route = programs.mesh_route
    one_card = make_mesh(4, devices=["cuda:0"] * 4)
    assert route(one_card, [cuda0], "data") == "capture"
    assert route(one_card, [], ("data",)) == "capture"
    assert route(one_card, [cuda0], None) == "capture"
    two_cards = make_mesh(2, devices=["cuda:0", "cuda:1"])
    assert route(two_cards, [cuda0], "data") == "capture"
    assert route(two_cards, [cuda0], None) == "capture"
    assert route(one_card, [torch.device("cuda", 1)], "data") == "eager"
    assert route(one_card, [torch.device("cpu")], "data") == "eager"
    cpu = make_mesh(8, devices=["cpu"] * 8)
    assert route(cpu, [torch.device("cpu")], "data") == "cpu"
    hier = programs_mesh(np.array(["cuda:0"] * 4).reshape(2, 2),
                         axis_names=("chip", "host"))
    assert route(hier, [cuda0], ("chip", "host")) == "capture"
    spanning = _process_mesh(monkeypatch)
    assert spanning.process_count == 2
    assert spanning.spans_processes("data")
    assert route(spanning, [cuda0], "data") == "eager"
    assert route(spanning, [cuda0], None) == "capture"
    assert route(_process_mesh(monkeypatch, device="cpu"), [],
                 "data") == "cpu"
    # the programs' own collective axes
    plan = tpipe.build_plan(64, 80, AkazeConfig(max_pts=64, noctaves=1))
    img = torch.zeros(64, 80)
    sp = tpipe._jit_spatial_detect_and_compute
    assert sp.collective_axes({}) == "data"
    assert sp.route(img, plan, cpu, False, True) == "cpu"
    assert sp.route(img, plan, one_card, False, True) == "eager"
    assert tspgo._run_sharded_pgo.collective_axes({"axis": ("chip",)}) \
        == ("chip",)


def test_mesh_route_captures_collectives_on_nccl(monkeypatch):
    """A key whose local shards share one card and whose collectives cross
    processes on NCCL is captured (each rank's graph holds the NCCL
    calls); on gloo it runs eagerly, as does a process of a process mesh
    over several cards, whatever the backend.  A mesh over four cards of
    one process is captured (one graph over the four)."""
    cuda0 = torch.device("cuda", 0)
    route = programs.mesh_route
    sp = tpipe._jit_spatial_detect_and_compute
    pgo = tspgo._run_sharded_pgo
    nccl = _process_mesh(monkeypatch, n=1, backend="cpu:gloo,cuda:nccl")
    assert route(nccl, [cuda0], "data") == "capture"
    assert route(nccl, [], ("data",)) == "capture"
    assert route(nccl, [cuda0], None) == "capture"
    assert route(nccl, [torch.device("cuda", 1)], "data") == "eager"
    assert sp.crosses_on_nccl((("mesh", nccl),))
    assert pgo.crosses_on_nccl((("mesh", nccl), ("axis", ("data",))))
    assert not pgo.crosses_on_nccl((("mesh", nccl), ("axis", ("chip",))))
    cards = _process_mesh(monkeypatch, backend="cpu:gloo,cuda:nccl",
                          devices=["cuda:0", "cuda:1"])
    assert route(cards, [cuda0], "data") == "eager"
    assert route(cards, [cuda0], None) == "eager"
    gloo = _process_mesh(monkeypatch, n=1)
    assert route(gloo, [cuda0], "data") == "eager"
    assert route(gloo, [cuda0], None) == "capture"
    assert not sp.crosses_on_nccl((("mesh", gloo),))
    # one process's mesh over four cards (make_mesh would span the two
    # processes the monkeypatched group answers for)
    four = programs_mesh([f"cuda:{i}" for i in range(4)])
    assert four.process_count == 1
    assert route(four, [cuda0], "data") == "capture"
    assert route(four, [], None) == "capture"
    assert not sp.crosses_on_nccl((("mesh", four),))


CARDS4 = [torch.device("cuda", i) for i in range(4)]


def fake(shape, device, dtype=torch.float32):
    """A tensor of ``shape`` that reports ``device`` (a CUDA card too, on
    a machine without one): what a key and a route read of a tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.empty(shape, dtype=dtype, device=device)


def mesh_program_calls(mesh, hc):
    """{name: (program, args, kwargs)}: each of the five mesh programs
    called as its public entry point calls it, the traced tensors on
    ``mesh``'s cards (per shard on the shard's card, the rest on its
    home); the landmark-sharded BA over ``hc`` (axes ("chip", "host"))."""
    plan = tpipe.build_plan(64, 80, AkazeConfig(max_pts=64, noctaves=1))
    home, devs = mesh.home, mesh.local_devices
    hdevs = hc.local_devices

    def pg(d):
        return tpg.PoseGraph(fake((8,), d, torch.int32),
                             fake((8,), d, torch.int32), fake((8, 3, 3), d),
                             fake((8, 3), d), fake((8,), d))

    def prob(d):
        return tba.BAProblem(fake((16,), d, torch.int32),
                             fake((16,), d, torch.int32), fake((16, 2), d),
                             fake((16,), d))

    R, t = fake((5, 3, 3), home), fake((5, 3), home)
    mask = fake((5,), home, torch.bool)
    lm = dict(iters=2, cg_iters=3, lam0=1e-3)
    return {
        "spatial": (tpipe._jit_spatial_detect_and_compute,
                    (fake((64, 80), home), plan, mesh, False, True), {}),
        "dp": (tdp._dp_step, ([fake((2, 64, 80), d) for d in devs],
                              [fake((2, 64, 80), d) for d in devs]),
               dict(plan=plan, mesh=mesh, fixed=False)),
        "pgo": (tspgo._run_sharded_pgo,
                (fake((16, 3, 3), home), fake((16, 3), home),
                 [pg(d) for d in devs], fake((16,), home, torch.bool)),
                dict(mesh=mesh, iters=2, cg_iters=3, damping=1e-6,
                     axis=("data",), robust="cauchy", robust_delta=1.0)),
        "ba observations": (tsba._run_sharded_ba,
                            (R, t, fake((12, 3), home),
                             [prob(d) for d in devs], mask),
                            dict(mesh=mesh, axis=("data",), **lm)),
        "ba landmarks": (tsba._run_landmark_sharded_ba,
                         (fake((5, 3, 3), hc.home), fake((5, 3), hc.home),
                          [fake((3, 3), d) for d in hdevs],
                          [prob(d) for d in hdevs],
                          fake((5,), hc.home, torch.bool)),
                         dict(mesh=hc, axis=("chip", "host"), **lm)),
    }


def test_four_card_mesh_captures_every_mesh_program():
    """Over ``make_mesh(4, devices=cuda:0..3)`` in one process each of the
    five mesh programs is captured, the dp step (no collective) included,
    and its key's cards are the four, the mesh's home first; the same
    calls with one traced tensor on the CPU, or on a card outside the
    mesh, run eagerly."""
    from akaze_tpu_torch.parallel import make_host_chip_mesh
    four = make_mesh(4, devices=CARDS4)
    hc = make_host_chip_mesh(1, 4, devices=CARDS4)
    calls = mesh_program_calls(four, hc)
    assert sorted(calls) == ["ba landmarks", "ba observations", "dp", "pgo",
                             "spatial"]
    for name, (prog, args, kw) in calls.items():
        assert prog.route(*args, **kw) == "capture", name
        key, leaves, statics, _ = prog.key(*args, **kw)
        assert prog._route(statics, leaves)[2] == CARDS4, name
        assert programs._cards_of_key(key) == CARDS4, name
        assert not prog.crosses_on_nccl(statics), name
    sp, args, _ = calls["spatial"]
    img = args[0]
    assert sp.route(torch.zeros(64, 80), *args[1:]) == "eager"
    assert sp.route(fake(img.shape, "cuda:4"), *args[1:]) == "eager"
    assert sp.route(fake(img.shape, "cuda:3"), *args[1:]) == "capture"
    # a mesh over two of the four cards: the key's two cards
    two = make_mesh(2, devices=CARDS4[2:])
    key = sp.key(fake(img.shape, "cuda:2"), args[1], two, False, True)[0]
    assert sp.route(fake(img.shape, "cuda:2"), args[1], two, False,
                    True) == "capture"
    assert programs._cards_of_key(key) == CARDS4[2:]


@pytest.mark.parametrize("backend", ["cpu:gloo,cuda:gloo",
                                     "cpu:gloo,cuda:nccl"],
                         ids=["gloo", "nccl"])
def test_process_mesh_over_two_cards_stays_eager(monkeypatch, backend):
    """A process whose share of a process mesh lies on two of its cards
    runs its mesh programs eagerly, on gloo and on NCCL (an NCCL rank
    drives one card): the spatial program (collectives over the process
    axis), with or without a traced tensor; one card of the same
    process mesh is captured on NCCL only."""
    cuda0 = torch.device("cuda", 0)
    route = programs.mesh_route
    cards = _process_mesh(monkeypatch, backend=backend,
                          devices=["cuda:0", "cuda:1"])
    assert cards.process_count == 2 and len(cards.local_devices) == 2
    assert route(cards, [cuda0], "data") == "eager"
    assert route(cards, [], ("data",)) == "eager"
    assert route(cards, [cuda0], None) == "eager"
    plan = tpipe.build_plan(64, 80, AkazeConfig(max_pts=64, noctaves=1))
    sp = tpipe._jit_spatial_detect_and_compute
    assert sp.route(fake((64, 80), "cuda:0"), plan, cards, False,
                    True) == "eager"
    one = _process_mesh(monkeypatch, n=1, backend=backend)
    assert sp.route(fake((64, 80), "cuda:0"), plan, one, False, True) == (
        "capture" if backend.endswith("nccl") else "eager")


def test_mesh_mixing_the_cpu_and_a_card_runs_eagerly():
    """A mesh whose shards lie on the CPU and on a card runs eagerly,
    whatever its traced tensors and collectives; so does a card mesh
    given a CPU tensor, and a CPU mesh given a card's."""
    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    route = programs.mesh_route
    mixed = programs_mesh(["cpu", "cuda:0"])
    for devices in ([], [cpu], [cuda0], [cpu, cuda0]):
        for axes in ("data", None):
            assert route(mixed, devices, axes) == "eager", (devices, axes)
    assert route(make_mesh(2, devices=CARDS4[:2]), [cpu], None) == "eager"
    assert route(make_mesh(2, devices=["cpu"] * 2), [cuda0],
                 None) == "eager"
    assert programs.key_cards(mixed) == [cpu, cuda0]


def test_key_cards_put_the_home_first_then_mesh_order():
    """A key's cards: the mesh's local devices in mesh order, each once
    (the home first), then the traced tensors' cards outside the mesh;
    ``"cuda"`` without an index is the current card."""
    d = [torch.device(x) for x in ("cuda:2", "cuda:0", "cuda:2", "cuda:1")]
    mesh = make_mesh(4, devices=d)
    assert mesh.home == d[0]
    want = [d[0], d[1], d[3]]
    assert programs.key_cards(mesh) == want
    assert programs.key_cards(mesh, [d[1], d[0]]) == want
    assert programs.key_cards(mesh, [torch.device("cuda", 3)]) == \
        want + [torch.device("cuda", 3)]
    assert programs.mesh_route(mesh, [torch.device("cuda", 3)],
                               "data") == "eager"
    assert programs.mesh_route(mesh, [d[3]], "data") == "capture"
    hier = programs_mesh(np.array(["cuda:1", "cuda:0", "cuda:1",
                                   "cuda:3"]).reshape(2, 2),
                         axis_names=("chip", "host"))
    assert programs.key_cards(hier) == [torch.device("cuda", i)
                                        for i in (1, 0, 3)]
    bare = programs.key_cards(make_mesh(2, devices=["cuda", "cuda"]))
    assert len(bare) == 1 and bare[0].type == "cuda" \
        and bare[0].index is not None


def test_stats_row_of_a_four_card_key(monkeypatch):
    """``stats()`` lists a captured key over four cards with
    ``eager=False``, its ``cards`` (home first), the bytes its capture
    added to each card's pool and their sum; ``clear()`` drops the key
    and every card's pool."""
    from akaze_tpu_torch.parallel import make_host_chip_mesh
    four = make_mesh(4, devices=CARDS4)
    prog, args, kw = mesh_program_calls(
        four, make_host_chip_mesh(1, 4, devices=CARDS4))["pgo"]
    key = prog.key(*args, **kw)[0]
    per = [3 << 20, 1 << 20, 0, 2 << 20]
    entry = programs._Entry(object(), CARDS4, [], [], [], None, [], per,
                            0.5, 0.25)
    entry.replays = 2
    monkeypatch.setitem(prog.entries, key, entry)
    monkeypatch.setattr(programs, "_POOLS",
                        {c: object() for c in CARDS4})
    rows = [r for r in programs.stats() if r["program"] == prog.name]
    assert len(rows) == 1
    row = rows[0]
    assert row["eager"] is False and row["nccl"] is False
    assert row["cards"] == [str(c) for c in CARDS4]
    assert row["card_pool_bytes"] == per and row["pool_bytes"] == sum(per)
    assert row["calls"] == 3 and row["replays"] == 2
    assert row["warmup_s"] == 0.5 and row["capture_s"] == 0.25
    assert "Mesh({'data': 4}" in row["key"]
    programs.clear()
    assert not prog.entries and not programs._POOLS


def test_calls_not_captured_see_the_graphs_inputs():
    """A call that is not captured (``eager()``, or a key the mesh rule
    runs eagerly) hands its function what a graph's input buffers hold:
    on the card every tensor contiguous (a matmul rounds otherwise on a
    transposed operand) and every number a 0-d tensor; on the CPU tensors
    as they are."""
    x = torch.arange(18.0).reshape(2, 3, 3).transpose(-1, -2)
    assert not x.is_contiguous()
    card = torch.device("cuda", 0)
    assert programs._eager_input(x, torch.device("cpu")) is x
    got = programs._eager_input(x, card)
    assert got.is_contiguous() and torch.equal(got, x)
    y = x.contiguous()
    assert programs._eager_input(y, card) is y
    n = programs._eager_input(0.5, torch.device("cpu"))
    assert n.dim() == 0 and n.dtype == torch.float32 and float(n) == 0.5


def test_mesh_keys_follow_the_mesh():
    """Equal meshes give one key (JAX's static ``mesh``), and other
    meshes, shard counts or devices other keys."""
    plan = tpipe.build_plan(64, 80, AkazeConfig(max_pts=64, noctaves=1))
    img = torch.zeros(64, 80)
    sp = tpipe._jit_spatial_detect_and_compute

    def key(mesh):
        return sp.key(img, plan, mesh, False, True)[0]

    a = make_mesh(4, devices=["cuda:0"] * 4)
    assert key(a) == key(make_mesh(4, devices=["cuda:0"] * 4))
    assert hash(key(a)) == hash(key(make_mesh(4, devices=["cuda:0"] * 4)))
    others = [key(make_mesh(2, devices=["cuda:0"] * 2)),
              key(make_mesh(4, devices=["cpu"] * 4)),
              key(make_mesh(4, devices=["cuda:1"] * 4)),
              key(programs_mesh(["cuda:0"] * 4, axis_names=("rows",)))]
    assert len(set(others + [key(a)])) == len(others) + 1
    assert "Mesh({'data': 4}" in programs.describe_key(key(a))


def test_mesh_keys_the_rule_refuses_run_eagerly_and_show_in_stats():
    """A key whose mesh the rule runs eagerly calls the function as it
    is on every call, captures nothing, and ``stats()`` lists it with
    ``eager=True`` and its calls; ``clear()`` drops it."""
    calls = []

    @programs.jit(static_argnames=("mesh",),
                  collective_axes=lambda statics: "data")
    def shifted(xs, mesh):
        calls.append(len(xs))
        return [x + 1 for x in xs]

    mesh = programs_mesh(["cpu", "meta"])
    xs = [torch.ones(3), torch.zeros(2)]
    assert shifted.route(xs, mesh) == "eager"
    for _ in range(3):
        out = shifted(xs, mesh)
        assert torch.equal(out[0], xs[0] + 1)
    assert calls == [2, 2, 2]
    assert shifted.captures == 0 and not shifted.entries
    rows = [r for r in programs.stats() if r["program"] == shifted.name]
    assert len(rows) == 1 and rows[0]["eager"] and rows[0]["calls"] == 3
    assert rows[0]["pool_bytes"] == 0 and "Mesh(" in rows[0]["key"]
    cpu = make_mesh(2, devices=["cpu"] * 2)
    assert shifted.route(xs, cpu) == "cpu"
    shifted(xs, cpu)
    assert len(shifted.eager_keys) == 1
    programs.clear()
    assert not shifted.eager_keys


def test_mesh_programs_on_the_cpu_run_their_functions():
    """On CPU shards each mesh program runs its function as it is:
    sharded PGO and BA give what their functions give bit for bit, no key
    is captured or marked eager, and a gauge mask made without an item
    assignment pins pose 0 as the given one does."""
    rng = np.random.default_rng(5)
    R0, t0, graph, fixed = pose_graph_problem(rng)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    g = tspgo.pad_edges(tpg.PoseGraph(*(t_(a) for a in graph)), 4)
    kw = dict(iters=4, robust="cauchy", robust_delta=10.0)
    got = tspgo.sharded_optimize_pose_graph(t_(R0), t_(t0), g, mesh, **kw)
    pinned = torch.arange(R0.shape[0]) == 0
    same = tspgo.sharded_optimize_pose_graph(t_(R0), t_(t0), g, mesh,
                                             fixed_mask=pinned, **kw)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    graphs = [tpg.PoseGraph(*fs) for fs in zip(
        *(torch.chunk(f, 4) for f in g))]
    want = tspgo._run_sharded_pgo.fn(
        t_(R0), t_(t0), graphs, pinned, mesh=mesh, iters=4, cg_iters=50,
        damping=1e-6, axis=("data",), robust="cauchy", robust_delta=10.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][0], t_(R0)[0])
    for p in (tspgo._run_sharded_pgo, tsba._run_sharded_ba,
              tsba._run_landmark_sharded_ba,
              tpipe._jit_spatial_detect_and_compute, tdp._dp_step):
        assert not p.entries and not p.eager_keys and p.captures == 0
