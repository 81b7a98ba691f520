"""The port's multi-device tier (``akaze_tpu_torch.parallel``) against the
JAX package's ``akaze_tpu.parallel``, on the CPU.

The port's meshes put several shards on one device
(``make_mesh(8, devices=["cpu"] * 8)``), the counterpart of the JAX
tests' eight virtual CPU devices (tests/conftest.py).

Tolerances:
  - meshes, block orders, ``compact_train``, ``sharded_match``,
    ``partition_landmarks`` and ``gather_points``/``scatter_points``
    exactly (integer work, or copies);
  - sums over shards in the port's fixed order exactly against the same
    order written out;
  - PGO: poses within 5e-4 of the port's single-device solver (held to
    JAX's in tests/test_torch_slam.py) and of JAX's sharded solver, the
    final cost within 1e-3 relative (or 1e-9 absolute): each sums in its
    own order;
  - BA (observation- and landmark-sharded): the JAX tests' tolerances
    (tests/test_parallel.py:57-100): cost within 1e-3 relative (1e-7
    absolute), X within 1e-2 relative (1e-3 absolute), R within 1e-4;
  - the data-parallel step equal to the port's per-pair path exactly, and
    to JAX's per-pair path within the pair path's tolerances
    (tests/test_torch_pipeline.py: counts exact, x/y 1e-4 px, 0 flipped
    bits, match indices exact);
  - ``SlamSystem(mesh)`` with JAX's draws replayed, against the
    single-device run of the same configuration (which
    tests/test_torch_slam.py holds to JAX's) and against JAX's
    ``SlamSystem(mesh)``: on a 3-D scene keyframes and edges equal,
    trajectories within 1e-2 of the map's extent (the JAX package's own
    mesh-vs-single bound, tests/test_vo_sequence.py:205-240); on the image
    route keyframes and edges equal, features equal to the single-device
    run's and within the pair path's tolerances of JAX's, descriptors
    within 1 flipped bit of JAX's (ROADMAP P9-6: on this planar route the
    bf16 planes' rounding flips one near-tied bit on 4 of 5 frames, on one
    device as well; 0 on f32 planes);
  - the CLI's ``--spatial`` counts equal to the single-device run's and to
    the JAX CLI's ``--spatial 2``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu import parallel as jpar
from akaze_tpu.geometry import se3_compose as jcompose
from akaze_tpu.geometry import se3_exp as jexp
from akaze_tpu.match import match as jmatch
from akaze_tpu.parallel.sharded_match import compact_train as jcompact
from akaze_tpu.pipeline import detect_and_compute_pair as jpair
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu.slam import ba as jba
from akaze_tpu.slam import posegraph as jpg
from akaze_tpu_torch import Akaze, AkazeConfig, build_plan, config_from
from akaze_tpu_torch import parallel as tpar
from akaze_tpu_torch.descriptor import words_to_numpy
from akaze_tpu_torch.match import match as tmatch
from akaze_tpu_torch.parallel import collectives as col
from akaze_tpu_torch.pipeline import detect_and_compute_pair
from akaze_tpu_torch.slam import ba as tba
from akaze_tpu_torch.slam import posegraph as tpg
from test_slam import make_ba_problem, make_trajectory, relative

torch.set_num_threads(1)

PGO_TOL = 5e-4


def t_(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jpar.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return tpar.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def thc():
    return tpar.make_host_chip_mesh(2, 4, devices=["cpu"] * 8)


# --------------------------------------------------------------------------
# meshes and collectives
# --------------------------------------------------------------------------

def test_make_mesh_follows_jax(tmesh8):
    assert tmesh8.shape == {"data": 8}
    assert hash(tmesh8) == hash(tpar.make_mesh(8, devices=["cpu"] * 8))
    assert tmesh8 == tpar.make_mesh(8, devices=["cpu"] * 8)
    assert tmesh8 != tpar.make_mesh(4, devices=["cpu"] * 4)
    for names in (("a", "b"), ("a", "b", "c")):
        want = dict(jpar.make_mesh(8, names).shape)
        assert tpar.make_mesh(8, names, devices=["cpu"] * 8).shape == want
    hc = tpar.make_host_chip_mesh(2, 4, devices=["cpu"] * 8)
    assert hc.shape == {"host": 2, "chip": 4}
    assert tpar.axis_size(hc, ("chip", "host")) == 8
    assert tpar.normalize_axes("data") == ("data",)
    with pytest.raises(ValueError, match="requested"):
        tpar.make_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested"):
            tpar.make_mesh(2)                  # no card visible


def test_public_names_follow_jax():
    """The package's ``__version__`` and ``distributed.mesh_axes``, as the
    JAX package's."""
    import akaze_tpu
    import akaze_tpu_torch
    from akaze_tpu.parallel import distributed as jdist
    from akaze_tpu_torch.parallel import distributed as tdist
    assert akaze_tpu_torch.__version__ == akaze_tpu.__version__ == "0.2.0"
    assert "__version__" in akaze_tpu_torch.__all__
    for names in (("data",), ("host", "chip"), ("a", "b", "c")):
        jmesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:1]).reshape((1,) * len(names)), names)
        tmesh = tpar.make_mesh(8, names, devices=["cpu"] * 8)
        assert tdist.mesh_axes(tmesh) == jdist.mesh_axes(jmesh) == names


def test_block_order_and_sums_follow_jax(jmesh8, thc):
    """Over ("chip", "host") JAX's tiled gather puts blocks chip-major; the
    port's does the same, and its sum runs chip first, then host."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    jhc = jpar.make_host_chip_mesh(num_hosts=2, chips_per_host=4)
    axes = ("chip", "host")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) * 1.1 + 0.3
    jg = shard_map(lambda a: jax.lax.all_gather(a, axes, tiled=True),
                   mesh=jhc, in_specs=P(axes), out_specs=P(),
                   check_vma=False)(x)
    xs = col.shard(t_(x), thc, axes)
    got = col.all_gather(xs, thc, axes)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    sums = col.psum(xs, thc, axes)
    blocks = x.reshape(8, 1, 3)       # block b = chip * 2 + host
    want = sum(sum(torch.from_numpy(blocks[c * 2 + h]) for c in range(4))
               for h in range(2))
    for s in sums:
        assert torch.equal(s, want)
    assert torch.equal(col.pmax(xs, thc, axes)[3],
                       torch.from_numpy(blocks.max(0)))


@pytest.mark.parametrize("edge", ["reflect", -7.0])
def test_extend_rows_matches_jax(jmesh8, tmesh8, edge):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from akaze_tpu.parallel.spatial import _extend_rows_of
    x = np.random.default_rng(0).random((8 * 6, 5)).astype(np.float32)
    jx = shard_map(lambda a: _extend_rows_of(a, 3, "data", 8, 0, edge),
                   mesh=jmesh8, in_specs=P("data"), out_specs=P("data"),
                   check_vma=False)(x)
    got = col.extend_rows(col.shard(t_(x), tmesh8), tmesh8, "data", 3,
                          edge=edge)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(jx))


def test_traced_records_operand_sizes(tmesh8):
    xs = col.shard(torch.ones(16, 6), tmesh8)
    with col.traced() as log:
        col.psum(xs, tmesh8)
        col.all_gather(xs, tmesh8)
    assert log == [("psum", 12), ("all_gather", 12)]


# --------------------------------------------------------------------------
# the sharded matcher
# --------------------------------------------------------------------------

def _words(rng, n):
    w = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32)
    w[:, 15] &= (1 << 6) - 1
    return w


def test_compact_train_matches_jax():
    rng = np.random.default_rng(1)
    n = 256
    words = _words(rng, n)
    v = np.zeros(n, bool)
    for d, k in enumerate(rng.integers(3, 12, 8)):
        v[d * 32:d * 32 + k] = True
    x = rng.uniform(0, 100, n).astype(np.float32)
    y = rng.uniform(0, 100, n).astype(np.float32)
    want = jax.jit(jcompact)(words, v, x, y)
    got = tpar.compact_train(t_(words.view(np.int32)), t_(v), t_(x), t_(y))
    np.testing.assert_array_equal(words_to_numpy(got[0]),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sharded_match_matches_jax_and_local(jmesh8, tmesh8):
    """Queries sharded, a gathered train set with a short valid prefix per
    shard: the indices refer to the gathered slots, and equal JAX's and
    the unsharded match."""
    rng = np.random.default_rng(1)
    n = 256
    w1, w2 = _words(rng, n), _words(rng, n)
    v1 = np.ones(n, bool)
    v2 = np.zeros(n, bool)
    for d, k in enumerate(rng.integers(3, 12, 8)):
        v2[d * 32:d * 32 + k] = True
    x2 = rng.uniform(0, 100, n).astype(np.float32)
    y2 = rng.uniform(0, 100, n).astype(np.float32)
    jm = jpar.sharded_match(*(jnp.asarray(a) for a in (w1, v1, w2, v2, x2,
                                                       y2)),
                            jmesh8, max_dist=486)
    args = (t_(w1.view(np.int32)), t_(v1), t_(w2.view(np.int32)), t_(v2),
            t_(x2), t_(y2))
    tm = tpar.gather_shards(tpar.sharded_match(*args, tmesh8, max_dist=486))
    local = tmatch(*args, max_dist=486)
    for f in ("index", "distance", "match_x", "match_y"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), f)
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      getattr(local, f).numpy(), f)
    assert (tm.index.numpy() >= 0).sum() > 50


# --------------------------------------------------------------------------
# pose-graph optimisation, edges sharded
# --------------------------------------------------------------------------

def _pose_graph(rng, n=8):
    """A drifted chain with two loop edges (one an outlier), padded to a
    multiple of 8 edges."""
    R_true, t_true = make_trajectory(rng, n)
    ei = list(range(n - 1)) + [0, 2]
    ej = list(range(1, n)) + [n - 1, 5]
    Rij, tij = [], []
    for a, b in zip(ei, ej):
        Rr, tr = relative(R_true[a], t_true[a], R_true[b], t_true[b])
        Rij.append(np.asarray(Rr))
        tij.append(np.asarray(tr))
    tij[-1] = tij[-1] + np.float32([2.0, 0.0, 0.0])
    graph = jpg.PoseGraph(jnp.asarray(ei, jnp.int32),
                          jnp.asarray(ej, jnp.int32),
                          jnp.asarray(np.stack(Rij)),
                          jnp.asarray(np.stack(tij)),
                          jnp.ones(len(ei), jnp.float32))
    noise = rng.standard_normal((n, 6)).astype(np.float32) * 0.05
    noise[0] = 0
    R0, t0 = jcompose(jnp.asarray(R_true), jnp.asarray(t_true),
                      *jexp(jnp.asarray(noise)))
    return np.asarray(R0), np.asarray(t0), jpar.pad_edges(graph, 8)


@pytest.mark.parametrize("robust,delta", [("none", 2.0), ("huber", 2.0),
                                          ("cauchy", 10.0)])
def test_sharded_pgo_matches_single_device_and_jax(rng, jmesh8, tmesh8, thc,
                                                   robust, delta):
    """Flat and (chip, host) meshes against the port's single-device solver
    (held to JAX's in tests/test_torch_slam.py) for every loss, and against
    JAX's sharded solver for the redescending one, whose threshold is the
    median of the gathered edge norms."""
    R0, t0, g = _pose_graph(rng)
    kw = dict(iters=6, robust=robust, robust_delta=delta)
    tg = tpg.PoseGraph(*(t_(a) for a in g))
    wants = [tpg.optimize_pose_graph(t_(R0), t_(t0), tg, **kw)]
    if robust == "cauchy":
        wants.append(jpar.sharded_optimize_pose_graph(
            jnp.asarray(R0), jnp.asarray(t0), g, jmesh8, **kw))
    for mesh, axis in ((tmesh8, "data"), (thc, ("chip", "host"))):
        Rt, tt, ct = tpar.sharded_optimize_pose_graph(
            t_(R0), t_(t0), tg, mesh, axis=axis, **kw)
        for want in wants:
            np.testing.assert_allclose(Rt.numpy(), np.asarray(want[0]),
                                       atol=PGO_TOL)
            np.testing.assert_allclose(tt.numpy(), np.asarray(want[1]),
                                       atol=PGO_TOL)
            np.testing.assert_allclose(float(ct), float(want[2]),
                                       rtol=1e-3, atol=1e-9)


def test_pad_edges_matches_jax(rng):
    _, _, g = _pose_graph(rng)
    sub = jpg.PoseGraph(*(a[:6] for a in g))    # 6 edges padded to 8
    tg = tpar.pad_edges(tpg.PoseGraph(*(t_(a) for a in sub)), 8)
    for a, b in zip(tg, jpar.pad_edges(sub, 8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# bundle adjustment, observations or landmark blocks sharded
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_problem():
    rng = np.random.default_rng(42)
    R, t, X, prob = make_ba_problem(rng, n_cams=5, n_pts=48)
    X0 = X + jax.random.normal(jax.random.PRNGKey(3), X.shape) * 0.04
    return (np.asarray(R), np.asarray(t), np.asarray(X0),
            jba.BAProblem(*(np.asarray(a) for a in prob)))


def _tprob(prob):
    return tba.BAProblem(*(t_(a) for a in prob))


def _ba_close(got, want):
    R, t, X, c = (v.numpy() if isinstance(v, torch.Tensor) else
                  np.asarray(v) for v in got)
    np.testing.assert_allclose(float(c), float(want[3]), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(X, np.asarray(want[2]), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(R, np.asarray(want[0]), atol=1e-4)


def test_sharded_bundle_adjust_matches_jax(ba_problem, jmesh8, tmesh8):
    R, t, X0, prob = ba_problem
    jp = jpar.pad_observations(jba.BAProblem(*(jnp.asarray(a)
                                               for a in prob)), 8)
    want = jpar.sharded_bundle_adjust(jnp.asarray(R), jnp.asarray(t),
                                      jnp.asarray(X0), jp, jmesh8, iters=6,
                                      cg_iters=25)
    got = tpar.sharded_bundle_adjust(
        t_(R), t_(t), t_(X0), tpar.pad_observations(_tprob(prob), 8),
        tmesh8, iters=6, cg_iters=25)
    _ba_close(got, want)
    single = tba.bundle_adjust(t_(R), t_(t), t_(X0), _tprob(prob),
                               n_cams=R.shape[0], n_pts=X0.shape[0],
                               iters=6, cg_iters=25)
    _ba_close(got, single)


def test_partition_landmarks_equals_jax(ba_problem):
    _, _, X0, prob = ba_problem
    for n_shards, mins in ((8, (0, 0)), (3, (24, 64))):
        want = jpar.partition_landmarks(jba.BAProblem(*(
            jnp.asarray(a) for a in prob)), X0.shape[0], n_shards, *mins)
        got = tpar.partition_landmarks(_tprob(prob), X0.shape[0], n_shards,
                                       *mins)
        assert (got.pts_per_shard, got.obs_per_shard) == (
            want.pts_per_shard, want.obs_per_shard)
        np.testing.assert_array_equal(got.point_perm, want.point_perm)
        for a, b in zip(got.prob, want.prob):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        Xg = tpar.gather_points(got, X0)
        np.testing.assert_array_equal(
            Xg.numpy(), np.asarray(jpar.gather_points(want, X0)))
        np.testing.assert_array_equal(tpar.scatter_points(got, Xg), X0)


@pytest.mark.parametrize("hier", [False, True])
def test_landmark_sharded_ba_matches_jax(ba_problem, jmesh8, tmesh8, thc,
                                         hier):
    R, t, X0, prob = ba_problem
    jpart = jpar.partition_landmarks(jba.BAProblem(*(
        jnp.asarray(a) for a in prob)), X0.shape[0], 8)
    axis = ("chip", "host") if hier else "data"
    jmesh = (jpar.make_host_chip_mesh(num_hosts=2, chips_per_host=4)
             if hier else jmesh8)
    Rj, tj, Xj, cj = jpar.landmark_sharded_bundle_adjust(
        jnp.asarray(R), jnp.asarray(t), jpar.gather_points(jpart, X0),
        jpart, jmesh, iters=5, cg_iters=20, axis=axis)
    part = tpar.partition_landmarks(_tprob(prob), X0.shape[0], 8)
    Rt, tt, Xt, ct = tpar.landmark_sharded_bundle_adjust(
        t_(R), t_(t), tpar.gather_points(part, X0), part,
        thc if hier else tmesh8, iters=5, cg_iters=20, axis=axis)
    assert len(Xt) == 8 and Xt[0].shape == (part.pts_per_shard, 3)
    # the blocks in block order (chip-major over ("chip", "host"))
    Xg = col.all_gather(Xt, thc if hier else tmesh8, axis, home_only=True)
    X1 = t_(tpar.scatter_points(part, Xg))
    _ba_close((Rt, tt, X1, ct),
              (Rj, tj, jpar.scatter_points(jpart, Xj), cj))
    single = tba.bundle_adjust(t_(R), t_(t), t_(X0), _tprob(prob),
                               n_cams=R.shape[0], n_pts=X0.shape[0],
                               iters=5, cg_iters=20)
    _ba_close((Rt, tt, X1, ct), single)
    assert float(ct) < float(tba.ba_cost(t_(R), t_(t), t_(X0),
                                         _tprob(prob))) * 1e-3


def test_landmark_sharded_ba_sums_only_camera_blocks(ba_problem, tmesh8):
    """No collective of the landmark-sharded solver carries a landmark-sized
    operand: the largest is a camera term, [C, 6, 6]; the
    observation-sharded solver's point-side sums do cross the mesh."""
    R, t, X0, prob = ba_problem
    n_cams = R.shape[0]
    part = tpar.partition_landmarks(_tprob(prob), X0.shape[0], 8)
    with col.traced() as log:
        tpar.landmark_sharded_bundle_adjust(
            t_(R), t_(t), tpar.gather_points(part, X0), part, tmesh8,
            iters=2, cg_iters=5)
    assert log and {n for n, _ in log} == {"psum"}
    assert max(k for _, k in log) <= n_cams * 36
    with col.traced() as log:
        tpar.sharded_bundle_adjust(t_(R), t_(t), t_(X0),
                                   tpar.pad_observations(_tprob(prob), 8),
                                   tmesh8, iters=1, cg_iters=2)
    assert max(k for _, k in log) >= X0.shape[0] * 9


# --------------------------------------------------------------------------
# data parallel
# --------------------------------------------------------------------------

DP_CFG = dict(max_pts=256, noctaves=2, dthreshold=1e-4)


@pytest.fixture(scope="module")
def dp_run():
    from mp_problem import make_frames
    a, b = make_frames(96, 128, 4)
    cfg = AkazeConfig(**DP_CFG)
    plan = build_plan(*a.shape[1:], cfg)
    mesh = tpar.make_mesh(4, devices=["cpu"] * 4)
    out = tpar.dp_pipeline_step(a, b, plan, mesh)
    return a, b, plan, mesh, out


def test_dp_step_keeps_results_on_shards(dp_run):
    *_, mesh, (fa, fb, m) = dp_run
    assert len(fa) == len(fb) == len(m) == 4
    assert fa[0].x.shape == (1, DP_CFG["max_pts"])
    assert fa[0].count.shape == (1,)


def test_dp_step_equals_per_pair_path(dp_run):
    a, b, plan, _, out = dp_run
    fa, fb, m = (tpar.gather_shards(x) for x in out)
    for i in range(a.shape[0]):
        ra, rb = detect_and_compute_pair(torch.as_tensor(a[i]),
                                         torch.as_tensor(b[i]), plan)
        rm = tmatch(ra.words, ra.valid, rb.words, rb.valid, rb.x, rb.y,
                    plan.config.max_dist)
        for got, want in ((fa, ra), (fb, rb), (m, rm)):
            for f, v in want._asdict().items():
                assert torch.equal(getattr(got, f)[i], v), f


def test_dp_step_matches_jax(dp_run):
    a, b, _, _, out = dp_run
    fa, fb, m = (tpar.gather_shards(x) for x in out)
    jcfg = JConfig(**DP_CFG)
    jplan = jbuild_plan(*a.shape[1:], jcfg)
    jp = jax.jit(lambda x, y: jpair(x, y, jplan))
    for i in (0, 3):
        ja, jb = jp(jnp.asarray(a[i]), jnp.asarray(b[i]))
        jm = jmatch(ja.words, ja.valid, jb.words, jb.valid, jb.x, jb.y,
                    jcfg.max_dist)
        n = int(ja.count)
        assert int(fa.count[i]) == n and n > 10
        np.testing.assert_allclose(fa.x[i, :n].numpy(), np.asarray(ja.x)[:n],
                                   atol=1e-4)
        x = words_to_numpy(fa.words[i, :n]) ^ np.asarray(ja.words)[:n]
        assert np.unpackbits(x.view(np.uint8)).sum() == 0
        np.testing.assert_array_equal(m.index[i].numpy(),
                                      np.asarray(jm.index))


def test_dp_multihost_in_one_process_equals_dp(dp_run):
    a, b, plan, mesh, out = dp_run
    got = tpar.dp_pipeline_step_multihost(a, b, plan, mesh)
    assert tpar.process_local_batch(4) == 4
    for x, y in zip(got, out):
        for u, v in zip(tpar.gather_shards(x), tpar.gather_shards(y)):
            assert torch.equal(u, v)


def test_batched_detect_and_compute_stacks_the_batch(dp_run):
    a, _, plan, *_ = dp_run
    f = tpar.batched_detect_and_compute(torch.as_tensor(a[:2]), plan)
    assert f.x.shape == (2, DP_CFG["max_pts"]) and f.count.shape == (2,)
    one = detect_and_compute_pair(torch.as_tensor(a[0]),
                                  torch.as_tensor(a[1]), plan)
    for i in range(2):
        assert torch.equal(f.words[i], one[i].words)


# --------------------------------------------------------------------------
# the entry points under a mesh
# --------------------------------------------------------------------------

def test_akaze_mesh_rules(monkeypatch):
    mesh = tpar.make_mesh(2, devices=["cpu"] * 2)
    det = Akaze(AkazeConfig(max_pts=64), mesh=mesh)
    assert det.device == torch.device("cpu") and det.mesh is mesh
    assert Akaze(mesh=mesh, device="cpu").mesh is mesh
    with pytest.raises(ValueError, match="mesh"):
        Akaze(mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="data"):
        Akaze(mesh=tpar.make_mesh(2, ("x",), devices=["cpu"] * 2))
    assert Akaze(mesh=tpar.make_mesh(1, devices=["cpu"])).mesh is None


def test_distributed_without_a_launcher(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tpar.initialize_distributed() is False
    assert tpar.initialize_distributed("tcp://localhost:1", 1, 0) is False
    assert tpar.HIER_AXES == ("chip", "host")
    assert tpar.process_local_batch(6) == 6


def test_dryrun_multichip_on_cpu_shards():
    out = tpar.dryrun_multichip(8, devices=["cpu"] * 8)
    assert len(out["counts"]) == 8 and min(out["counts"]) > 20
    assert out["matched"] > 20 and out["spatial_count"] > 20
    for k in ("ba_cost", "pgo_cost", "hostchip_lm_ba_cost"):
        assert np.isfinite(out[k]) and out[k] < 1e-3, k


def test_cli_spatial_matches_single_device(tmp_path, capsys, monkeypatch,
                                           test_image):
    """``--spatial 2`` and ``--spatial 4`` on CPU shards give the counts of
    the single-device run and of the JAX CLI's ``--spatial 2`` (its timing
    scans, which report only times, are replaced by zeros)."""
    from akaze_tpu import cli as jcli
    from akaze_tpu_torch import cli
    from akaze_tpu_torch.io import save_pgm
    a = (test_image[:, :248] * 255).astype(np.uint8)
    b = (test_image[:, 5:253] * 255).astype(np.uint8)
    paths = [str(tmp_path / n) for n in ("a.pgm", "b.pgm")]
    for p, im in zip(paths, (a, b)):
        save_pgm(p, im)
    base = ["--left", paths[0], "--right", paths[1], "--device", "cpu",
            "--json", "--no-draw", "--iters", "1", "--max-pts", "1024"]
    outs = []
    for extra in ([], ["--spatial", "2"], ["--spatial", "4"]):
        cli.main(base + extra)
        outs.append(json.loads(capsys.readouterr().out.strip()))
    monkeypatch.setattr("akaze_tpu.profiling.scan_time",
                        lambda *a, **kw: 0.0)
    jcli.main(base[:4] + base[6:] + ["--spatial", "2"])
    outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    for o in outs[1:]:
        for k in ("left_pts", "right_pts", "matches", "overflow"):
            assert o[k] == outs[0][k], k
    assert outs[0]["matches"] > 10
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested"):
            cli.main(base[:-6] + ["--device", "cuda", "--spatial", "2"])


# --------------------------------------------------------------------------
# SlamSystem on a mesh
# --------------------------------------------------------------------------

def _slam_runs(frames, feats, jfeats, intr, mesh_kw, jmesh):
    """The port's single-device and mesh runs and JAX's mesh run of the
    same route; the port replays JAX's draws."""
    from akaze_tpu.slam import odometry as jodo
    from akaze_tpu.slam import system as jsys
    from akaze_tpu_torch.slam import odometry as todo
    from akaze_tpu_torch.slam import system as tsys
    from test_torch_slam import AKAZE_CFG, SLAM_CFG, VO_CFG, Replay
    runs = []
    for kw in ({"device": "cpu"}, mesh_kw):
        s = tsys.SlamSystem(todo.Intrinsics(**intr),
                            config_from(JConfig(**AKAZE_CFG)),
                            tsys.SlamConfig(**SLAM_CFG), **kw, **VO_CFG)
        s.vo.sampler = Replay(0)
        if feats is not None:
            s.vo.akaze.detect_and_compute = lambda k: feats[k]
        for f in frames:
            s.process(f)
        runs.append(s)
    js = jsys.SlamSystem(jodo.Intrinsics(**intr), JConfig(**AKAZE_CFG),
                         jsys.SlamConfig(**SLAM_CFG), mesh=jmesh, **VO_CFG)
    if jfeats is not None:
        js.vo.akaze.detect_and_compute = lambda k: jfeats[k]
    for f in frames:
        js.process(f)
    return runs + [js]


def _same_keyframes_and_edges(a, b):
    assert [k.index for k in a.vo.keyframes] == [k.index
                                                 for k in b.vo.keyframes]
    assert [e[:2] for e in a.edges] == [e[:2] for e in b.edges]


def test_slam_system_mesh_on_a_3d_scene_matches_single_device():
    """Sharded PGO and landmark-sharded local BA inside the SLAM loop, on
    features of a 3-D scene fed in place of detection, with JAX's draws
    replayed: keyframes and edges equal to the single-device run's (the
    run tests/test_torch_slam.py holds to JAX's) and to JAX's
    ``SlamSystem(mesh)`` on 4 devices, trajectories within 1e-2 of the
    map's extent of both."""
    from akaze_tpu.pipeline import Features as JFeatures
    from akaze_tpu_torch.io.dataset import projected_sequence
    from akaze_tpu_torch.pipeline import features_from_numpy
    frames, _ = projected_sequence(np.random.default_rng(5))
    intr = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    feats = [features_from_numpy(f, "cpu") for f in frames]
    jfeats = [JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
              for f in frames]
    mesh = tpar.make_mesh(4, devices=["cpu"] * 4)
    single, sharded, js = _slam_runs(range(len(frames)), feats, jfeats,
                                     intr, {"mesh": mesh},
                                     jpar.make_mesh(4))
    assert [e for e in single.edges if e[1] != e[0] + 1], "no loop edge"
    for ref in (single, js):
        _same_keyframes_and_edges(sharded, ref)
        want = ref.keyframe_trajectory()
        np.testing.assert_allclose(sharded.keyframe_trajectory(), want,
                                   atol=1e-2 * float(np.abs(want).max()))


def test_slam_system_mesh_on_images_matches_single_device():
    """The image route with detection row-sharded over two shards: the
    spatial tier's features equal the single-device ones, so keyframes,
    edges and every keyframe's features agree; against JAX's
    ``SlamSystem(mesh)`` on 2 devices keyframes and edges are equal and
    each keyframe's features agree within the pair path's tolerances
    (counts exact, x/y 1e-4 px), descriptors within 1 flipped bit
    (ROADMAP P9-6: bf16 sampling, single-device as well).  The scene is
    planar, so trajectories are compared with the port's single-device
    run only (tests/test_torch_slam.py says why)."""
    from test_torch_slam import IMG_INTR, image_sequence
    frames, _ = image_sequence()
    mesh = tpar.make_mesh(2, devices=["cpu"] * 2)
    single, sharded, js = _slam_runs(frames, None, None, IMG_INTR,
                                     {"mesh": mesh}, jpar.make_mesh(2))
    assert sharded.vo.akaze.mesh is mesh
    assert sharded.vo.akaze.spatial_fallbacks == 0
    for ref in (single, js):
        _same_keyframes_and_edges(sharded, ref)
    assert len(sharded.vo.keyframes) > 3
    for ka, kb, kj in zip(sharded.vo.keyframes, single.vo.keyframes,
                          js.vo.keyframes):
        for f in ("x", "y", "words", "valid"):
            assert torch.equal(getattr(ka.features, f),
                               getattr(kb.features, f)), f
        n = int(kj.features.count)
        assert int(ka.features.count) == n
        for f in ("x", "y"):
            np.testing.assert_allclose(
                getattr(ka.features, f)[:n].numpy(),
                np.asarray(getattr(kj.features, f))[:n], atol=1e-4)
        flips = np.unpackbits((words_to_numpy(ka.features.words)[:n]
                               ^ np.asarray(kj.features.words)[:n])
                              .view(np.uint8), axis=1).sum(1)
        assert flips.max() <= 1, flips.max()               # P9-6
    np.testing.assert_allclose(sharded.keyframe_trajectory(),
                               single.keyframe_trajectory(), atol=1e-2)
