"""The PyTorch port's SLAM path (``akaze_tpu_torch.slam``) against the JAX
package on the same seeded inputs, on the CPU.

The port's RANSAC draws differ from ``jax.random.categorical``; wherever a
two-view solve is compared, the port is fed the [K, 8] sets that the JAX
package's ``_sample_minimal_sets`` drew (``Replay``: the JAX VO's key
sequence, ``PRNGKey(seed)`` split once per two-view solve).

Tolerances (float32 on both sides):
  - PGO: poses within 5e-4 and the final cost within 1e-4 relative;
  - BA: rotations within 1e-4, translations within 1e-3, points within
    5e-3 (the monocular scale direction is weakly held by the damping), the
    final cost within 1e-3 relative or 1e-9 absolute;
  - ``_masked_median``, ``KeyframeIndex`` candidates and match counts,
    ``build_local_ba``'s indices, ``loop_edge_measurement`` and every
    checkpoint round trip exactly; signatures within 1e-6; the landmarks
    ``build_local_ba`` triangulates within 1e-4 relative (rays of a short
    baseline);
  - ``_two_view`` on synthetic 3-D features: matches exactly, R and t
    within 1e-4, inlier masks equal, landmarks within 1e-4 relative;
  - the slice on projected 3-D features (non-degenerate two-view
    geometry): keyframes and edges (i, j) equal, edge weights within 1e-2
    (a loop edge's weight falls with the spread, a median absolute
    deviation, of its depth ratios), the keyframe and frame trajectories
    within 1e-3 of the map's extent;
  - the slice on ``synthetic_sequence`` images: keyframes and edges (i, j)
    equal, odometry edge weights equal, every pose finite.  Its loop edge
    weights and trajectory are not compared: the scene is a plane under
    translation, so each 8-point system has a 3-dimensional null space
    (``test_planar_minimal_sets_are_degenerate``) and each RANSAC
    hypothesis is whichever null vector the eigensolver returns.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu.geometry import se3_compose as jcompose
from akaze_tpu.geometry import se3_exp as jexp
from akaze_tpu.geometry import so3_exp as jso3_exp
from akaze_tpu.geometry.ransac import _sample_minimal_sets
from akaze_tpu import pipeline as jpipe
from akaze_tpu.io import synthetic_sequence
from akaze_tpu.slam import ba as jba
from akaze_tpu.slam import checkpoint as jckpt
from akaze_tpu.slam import odometry as jodo
from akaze_tpu.slam import posegraph as jpg
from akaze_tpu.slam import system as jsys
from akaze_tpu_torch import AkazeConfig, config_from
from akaze_tpu_torch.descriptor import words_to_numpy
from akaze_tpu_torch.io.dataset import projected_sequence
from akaze_tpu_torch.pipeline import features_from_numpy
from akaze_tpu_torch.slam import ba as tba
from akaze_tpu_torch.slam import checkpoint as tckpt
from akaze_tpu_torch.slam import odometry as todo
from akaze_tpu_torch.slam import posegraph as tpg
from akaze_tpu_torch.slam import system as tsys
from test_odometry import INTR, project_features, synth_features
from test_slam import make_ba_problem, make_trajectory, relative

torch.set_num_threads(1)

_sample_sets = jax.jit(_sample_minimal_sets, static_argnums=(2, 3))


def t_(a):
    return torch.from_numpy(np.array(a))


class Replay:
    """A port sampler that replays the JAX VO's draws: its own
    ``PRNGKey(seed)``, split once per two-view solve, through the JAX
    package's ``_sample_minimal_sets`` on the port's putative mask."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, key, mask, num_hyps):
        self.key, sub = jax.random.split(self.key)
        sets = _sample_sets(sub, jnp.asarray(mask.cpu().numpy()), num_hyps, 8)
        return torch.from_numpy(np.asarray(sets)).to(mask.device)


def jax_sets_for(key):
    """A port sampler returning the sets JAX draws from ``key``."""
    def sampler(_, mask, num_hyps):
        return torch.from_numpy(np.asarray(_sample_sets(
            key, jnp.asarray(mask.cpu().numpy()), num_hyps, 8)))
    return sampler


# --------------------------------------------------------------------------
# pose-graph optimisation and bundle adjustment
# --------------------------------------------------------------------------

def pose_graph_problem(rng, n=7, cap=8):
    """A drifted chain with two loop edges, one of them an outlier, padded
    as ``SlamSystem.optimize`` pads (identity poses, gauge-fixed, up to
    ``cap``)."""
    R_true, t_true = make_trajectory(rng, n)
    ei = list(range(n - 1)) + [0, 2]
    ej = list(range(1, n)) + [n - 1, 5]
    Rij, tij = [], []
    for a, b in zip(ei, ej):
        Rr, tr = relative(R_true[a], t_true[a], R_true[b], t_true[b])
        Rij.append(np.asarray(Rr))
        tij.append(np.asarray(tr))
    Rij, tij = np.stack(Rij), np.stack(tij)
    tij[-1] += np.float32([2.0, 0.0, 0.0])
    w = np.ones(len(ei), np.float32)
    noise = rng.standard_normal((n, 6)).astype(np.float32) * 0.05
    noise[0] = 0
    dR, dt = jexp(jnp.asarray(noise))
    R0, t0 = jcompose(jnp.asarray(R_true), jnp.asarray(t_true), dR, dt)
    R = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
    t = np.zeros((cap, 3), np.float32)
    R[:n], t[:n] = np.asarray(R0), np.asarray(t0)
    fixed = np.zeros(cap, bool)
    fixed[0] = True
    fixed[n:] = True
    graph = (np.asarray(ei, np.int32), np.asarray(ej, np.int32), Rij, tij, w)
    return R, t, graph, fixed


@pytest.mark.parametrize("robust,delta", [("none", 2.0), ("huber", 2.0),
                                          ("cauchy", 10.0)])
def test_optimize_pose_graph_matches_jax(rng, robust, delta):
    tol = 5e-4
    R0, t0, graph, fixed = pose_graph_problem(rng)
    kw = dict(iters=10, robust=robust, robust_delta=delta)
    Rj, tj, cj = jpg.optimize_pose_graph(
        jnp.asarray(R0), jnp.asarray(t0),
        jpg.PoseGraph(*(jnp.asarray(a) for a in graph)),
        fixed_mask=jnp.asarray(fixed), **kw)
    Rt, tt, ct = tpg.optimize_pose_graph(
        t_(R0), t_(t0), tpg.PoseGraph(*(t_(a) for a in graph)),
        fixed_mask=t_(fixed), **kw)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=tol)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=tol)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    np.testing.assert_array_equal(Rt.numpy()[fixed], R0[fixed])   # gauge
    assert np.abs(Rt.numpy() - R0).max() > 10 * tol                # moved


@pytest.mark.parametrize("x,mask", [
    ([3, 1, 2, 5, 4, 7], [1, 1, 1, 1, 0, 0]),
    ([3, 1, 2, 5, 4, 7], [1, 1, 1, 1, 1, 0]),
    ([3, 1, 2, 5, 4, 7], [0, 0, 0, 0, 0, 0]),
    ([0.5, -2.0, np.inf, 1.0], [1, 1, 1, 0]),
])
def test_masked_median_matches_jax(x, mask):
    x = np.asarray(x, np.float32)
    mask = np.asarray(mask, bool)
    want = float(jpg._masked_median(jnp.asarray(x), jnp.asarray(mask)))
    assert float(tpg._masked_median(t_(x), t_(mask))) == want


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_bundle_adjust_matches_jax(rng, noise):
    R, t, X, prob = make_ba_problem(rng, noise=noise)
    n_cams, n_pts = R.shape[0], X.shape[0]
    dxi = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                       (n_cams, 6))) * 0.02
    dxi[0] = 0.0
    dR, dt = jexp(jnp.asarray(dxi))
    R0, t0 = jax.vmap(jcompose)(R, t, dR, dt)
    X0 = X + jax.random.normal(jax.random.PRNGKey(1), X.shape) * 0.03
    fixed = np.zeros(n_cams, bool)
    fixed[0] = fixed[3] = True
    out_j = jba.bundle_adjust(R0, t0, X0, prob, n_cams=n_cams, n_pts=n_pts,
                              iters=8, fixed_cam_mask=jnp.asarray(fixed))
    out_t = tba.bundle_adjust(
        *(t_(a) for a in (R0, t0, X0)),
        tba.BAProblem(*(t_(a) for a in prob)), n_cams=n_cams, n_pts=n_pts,
        iters=8, fixed_cam_mask=t_(fixed))
    for got, want, tol in zip(out_t[:3], out_j[:3], (1e-4, 1e-3, 5e-3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(float(out_t[3]), float(out_j[3]), rtol=1e-3,
                               atol=1e-9)
    for c in (0, 3):                                       # gauge held
        np.testing.assert_array_equal(out_t[0][c].numpy(), np.asarray(R0[c]))
    assert float(out_t[3]) < float(tba.ba_cost(
        *(t_(a) for a in (R0, t0, X0)), tba.BAProblem(*(t_(a) for a in prob))))


# --------------------------------------------------------------------------
# odometry building blocks on synthetic 3-D features
# --------------------------------------------------------------------------

def test_two_view_matches_jax(rng):
    X, words = synth_features(rng, n_pts=120)
    R2 = np.asarray(jso3_exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)))
    t2 = np.asarray([0.8, 0.1, 0.05], np.float32)
    # 512 slots, as in the slices below: one compile of each JAX program
    f1 = project_features(X, words, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), n_pad=512)
    f2 = project_features(X, words, R2, t2, n_pad=512)
    # half a pixel of noise in the second view, so the geometry is not exact
    f2 = f2._replace(x=f2.x + jnp.asarray(rng.normal(0, 0.5, 512),
                                          jnp.float32))
    key = jax.random.PRNGKey(4)
    m, res, X1, z1, z2 = jodo._two_view(key, f1, f2, INTR.fx, INTR.fy,
                                        INTR.cx, INTR.cy, 2e-5)
    g1, g2 = features_from_numpy(f1, "cpu"), features_from_numpy(f2, "cpu")
    mt, rt, X1t, z1t, z2t = todo._two_view(
        None, g1, g2, INTR.fx, INTR.fy, INTR.cx, INTR.cy, 2e-5,
        sampler=jax_sets_for(key))
    for a, b in zip(mt, m):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(res.inliers))
    assert int(rt.num_inliers) == int(res.num_inliers) > 80
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(res.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(res.t), atol=1e-4)
    inl = np.asarray(res.inliers)
    for a, b in ((X1t, X1), (z1t, z1), (z2t, z2)):
        a, b = a.numpy()[inl], np.asarray(b)[inl]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _local_ba_window(rng, n_kf=4):
    X, words = synth_features(rng, n_pts=120)
    poses, feats = [], []
    for k in range(n_kf):
        R = np.asarray(jso3_exp(jnp.asarray([0.0, 0.01 * k, 0.0],
                                            jnp.float32)), np.float32)
        t = np.asarray([-0.5 * k, 0.0, 0.0], np.float32)
        poses.append((R, t))
        feats.append(project_features(X, words, R, t, n_pad=512))
    return poses, feats


def _collide(f1, f2):
    """Identity matching, except that slots 0 and 1 both claim slot 0."""
    idx = np.arange(f1.x.shape[0], dtype=np.int32)
    valid = (f1.valid.numpy() if isinstance(f1.valid, torch.Tensor)
             else np.asarray(f1.valid))
    idx[~valid] = -1
    idx[1] = 0
    return idx


@pytest.mark.parametrize("matcher", ["K4", "collision"])
def test_build_local_ba_matches_jax(rng, matcher):
    poses, feats = _local_ba_window(rng)
    fn = _collide if matcher == "collision" else None
    Rj, tj, Xj, pj = jodo.build_local_ba(feats, poses, INTR, max_pts=150,
                                         matches_fn=fn)
    Rt, tt, Xt, pt = todo.build_local_ba(
        [features_from_numpy(f, "cpu") for f in feats], poses, INTR,
        max_pts=150, matches_fn=fn)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(pt, pj):
        assert a.dtype == {jnp.int32: torch.int32,
                           jnp.float32: torch.float32}[b.dtype.type]
    np.testing.assert_array_equal(pt.cam.numpy(), np.asarray(pj.cam))
    np.testing.assert_array_equal(pt.pt.numpy(), np.asarray(pj.pt))
    np.testing.assert_array_equal(pt.w.numpy(), np.asarray(pj.w))
    np.testing.assert_allclose(pt.uv.numpy(), np.asarray(pj.uv), atol=1e-6)


# --------------------------------------------------------------------------
# loop closure
# --------------------------------------------------------------------------

def test_keyframe_index_matches_jax(rng):
    jidx, tidx = jsys.KeyframeIndex(), tsys.KeyframeIndex()
    X0, words0 = synth_features(rng, n_pts=80)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for k in range(12):
        if k in (0, 11):
            X, words = X0, words0
        elif k == 6:                     # a partial revisit of keyframe 0
            X, words = synth_features(rng, n_pts=80)
            X[:40], words[:40] = X0[:40], words0[:40]
        else:
            X, words = synth_features(rng, n_pts=80)
        t = np.asarray([0.05 * k, 0.0, 0.0], np.float32)
        f = project_features(X, words, eye, t if k != 11 else zero,
                             n_pad=512)
        jidx.add(f)
        tidx.add(features_from_numpy(f, "cpu"))
    assert len(tidx) == len(jidx) == 12
    np.testing.assert_allclose(np.stack(tidx._sigs), np.stack(jidx._sigs),
                               atol=1e-6)
    for q, gap, top in ((11, 3, 4), (11, 5, 2), (6, 2, 3), (2, 5, 4)):
        cand = tidx.candidates(q, gap, top)
        np.testing.assert_array_equal(cand, jidx.candidates(q, gap, top))
    for q, cand in ((11, np.asarray([0, 6])), (11, np.asarray([3, 5])),
                    (6, np.asarray([0])), (11, np.empty(0, np.int64))):
        np.testing.assert_array_equal(tidx.match_counts(q, cand),
                                      jidx.match_counts(q, cand))
    assert tidx.match_counts(11, np.asarray([0]))[0] >= 50


@pytest.mark.parametrize("scale", [None, 0.37])
def test_loop_edge_measurement_matches_jax(rng, scale):
    R_all, t_all = make_trajectory(rng, 4)
    R_rel = R_all[1] @ R_all[3].T
    t_dir = rng.standard_normal(3).astype(np.float32)
    t_dir /= np.linalg.norm(t_dir)
    args = (R_all[3], t_all[3], R_all[1], t_all[1], R_rel, t_dir)
    for a, b in zip(tsys.loop_edge_measurement(*args, scale=scale),
                    jsys.loop_edge_measurement(*args, scale=scale)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# checkpoint module
# --------------------------------------------------------------------------

def test_tree_flatten_orders_leaves_as_jax(tmp_path):
    tree = {"b": None, "a": [np.arange(2), np.ones(3)],
            "c": {"z": np.zeros(1), "y": None, "x": (np.int32(4),)}}
    leaves, _ = tckpt.tree_flatten(tree)
    jleaves = jax.tree.leaves(tree)
    assert len(leaves) == len(jleaves) == 4
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a, b)
    # a file of either package loads in the other, like= or not
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_checkpoint(pt, tree, metadata={"step": 3})
    jckpt.save_checkpoint(pj, tree, metadata={"step": 3})
    for p in (pt, pj):
        for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
            state, meta = load(p, like=tree)
            assert meta == {"step": 3}
            for a, b in zip(jax.tree.leaves(state), jleaves):
                np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(pj, like={"a": np.zeros(2)})


def test_checkpoint_directory_rotation(tmp_path):
    d = str(tmp_path / "ckpts")
    assert tckpt.latest_step(d) == -1
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path))
    for step in range(5):
        tckpt.save_checkpoint(d, {"x": torch.full((3,), step)}, keep=3)
    assert len(os.listdir(d)) == 3
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 4
    state, _ = tckpt.load_checkpoint(d, like={"x": None, "y": [0]})
    np.testing.assert_array_equal(state["y"][0], [4, 4, 4])


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

IMG_SIZE = (160, 224)
IMG_INTR = dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0)
# every tracked frame a keyframe (keyframe_inlier_ratio > 1); loop
# thresholds far below the counts the two packages observe on this
# sequence (match counts of the verified candidates >= 36, inliers >= 20)
SLAM_CFG = dict(optimize_every=4, min_loop_gap=2, loop_min_matches=25,
                loop_min_inliers=8, loop_candidates=2, max_loops_per_kf=1,
                local_ba_every=3, local_ba_window=3, local_ba_points=64)
VO_CFG = dict(min_inliers=6, keyframe_inlier_ratio=1.05)
AKAZE_CFG = dict(max_pts=512, noctaves=2, dthreshold=5e-5)


def image_sequence(n_out=3, step=40):
    """An out-and-back route over ``synthetic_sequence``: outbound frames
    ``step`` px apart, then the way back a quarter step off the outbound
    positions, so that each return keyframe has one clear loop partner."""
    q = step // 4
    frames, offsets = synthetic_sequence(
        np.random.default_rng(3), n_frames=4 * (n_out - 1) + 1,
        size=IMG_SIZE, shift_per_frame=(0.0, float(q)), n_blobs=300)
    order = (list(range(0, 4 * (n_out - 1) + 1, 4))
             + list(range(4 * (n_out - 1) - 1, 0, -4)))
    return [frames[k].astype(np.float32) / 255.0 for k in order], order


def _instrument(system):
    """Record each PGO and local-BA call of ``system`` and its result."""
    log = []
    for name in ("optimize", "local_bundle_adjust"):
        fn = getattr(system, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, out))
            return out
        setattr(system, name, wrapped)
    return log


def _run_pair(feed_j, feed_t, frames, intr_j, intr_t):
    js = jsys.SlamSystem(intr_j, JConfig(**AKAZE_CFG),
                         jsys.SlamConfig(**SLAM_CFG), **VO_CFG)
    ts = tsys.SlamSystem(intr_t, config_from(JConfig(**AKAZE_CFG)),
                         tsys.SlamConfig(**SLAM_CFG), device="cpu", **VO_CFG)
    ts.vo.sampler = Replay(0)
    if feed_j is not None:
        js.vo.akaze.detect_and_compute = feed_j
        ts.vo.akaze.detect_and_compute = feed_t
    logs = _instrument(js), _instrument(ts)
    for f in frames:
        js.process(f)
        ts.process(f)
    return js, ts, logs


@pytest.fixture(scope="module")
def image_runs():
    frames, _ = image_sequence()
    return _run_pair(None, None, frames, jodo.Intrinsics(**IMG_INTR),
                     todo.Intrinsics(**IMG_INTR))


@pytest.fixture(scope="module")
def projected_runs():
    """The slice on keypoints of a 3-D scene (``projected_sequence``), fed
    to both packages in place of detection."""
    frames, centres = projected_sequence(np.random.default_rng(5))
    jfeats = [jpipe.Features(**{k: jnp.asarray(v) for k, v in f.items()})
              for f in frames]
    tfeats = [features_from_numpy(f, "cpu") for f in frames]
    intr = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    return _run_pair(lambda k: jfeats[k], lambda k: tfeats[k],
                     range(len(frames)), jodo.Intrinsics(**intr),
                     todo.Intrinsics(**intr)) + (centres,)


def _assert_same_structure(js, ts, logs):
    assert ([k.index for k in ts.vo.keyframes]
            == [k.index for k in js.vo.keyframes])
    assert [e[:2] for e in ts.edges] == [e[:2] for e in js.edges]
    loops = [e for e in js.edges if e[0] - e[1] != -1]
    assert loops, "no loop edge"
    lj, lt = logs
    assert [n for n, _ in lt] == [n for n, _ in lj]
    assert "optimize" in [n for n, _ in lj]
    ba = [c for n, c in lt if n == "local_bundle_adjust"]
    assert ba and all(c is not None and np.isfinite(c) for c in ba)
    for s in (js, ts):
        for k in s.vo.keyframes:
            assert np.isfinite(k.R).all() and np.isfinite(k.t).all()


def test_slice_on_images_matches_jax(image_runs):
    js, ts, logs = image_runs
    _assert_same_structure(js, ts, logs)
    assert len(ts.vo.keyframes) == len(image_sequence()[1])
    for ej, et in zip(js.edges, ts.edges):
        if ej[1] == ej[0] + 1:                      # odometry edges
            assert et[4] == ej[4]
    assert np.isfinite(ts.keyframe_trajectory()).all()


def test_planar_minimal_sets_are_degenerate(image_runs):
    """Why the image run's trajectories are not compared: on the planar
    sequence the 8-point system of matched keyframes has a 3-dimensional
    null space."""
    js, _, _ = image_runs
    f1, f2 = js.vo.keyframes[0].features, js.vo.keyframes[1].features
    m = jodo.match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y)
    ok = np.asarray(m.index) >= 0
    fx, cx, cy = IMG_INTR["fx"], IMG_INTR["cx"], IMG_INTR["cy"]
    x1 = np.stack([(np.asarray(f1.x)[ok] - cx) / fx,
                   (np.asarray(f1.y)[ok] - cy) / fx, np.ones(ok.sum())], 1)
    x2 = np.stack([(np.asarray(m.match_x)[ok] - cx) / fx,
                   (np.asarray(m.match_y)[ok] - cy) / fx,
                   np.ones(ok.sum())], 1)
    A = (x2[:, :, None] * x1[:, None, :]).reshape(-1, 9).astype(np.float64)
    sv = np.linalg.svd(A, compute_uv=False)
    assert ok.sum() >= 20
    assert sv[-3] / sv[0] < 2e-3 < sv[-4] / sv[0]


def test_slice_on_projected_features_matches_jax(projected_runs):
    js, ts, logs, centres = projected_runs
    _assert_same_structure(js, ts, logs)
    np.testing.assert_allclose([e[4] for e in ts.edges],
                               [e[4] for e in js.edges], atol=1e-2)
    tj, tt = js.keyframe_trajectory(), ts.keyframe_trajectory()
    extent = float(np.abs(tj).max())
    np.testing.assert_allclose(tt, tj, atol=1e-3 * extent)
    np.testing.assert_allclose(ts.vo.trajectory(), js.vo.trajectory(),
                               atol=1e-3 * extent)


def test_keyframe_ate_matches_jax(projected_runs):
    """Absolute trajectory error (``io.ate_rmse``, similarity-aligned) of
    each package's keyframe trajectory against the scene's true camera
    centres at the keyframes' frames: the two within 1e-3 of the centres'
    extent (the trajectory test's tolerance)."""
    from akaze_tpu.io import ate_rmse as jate
    from akaze_tpu_torch.io import ate_rmse as tate
    js, ts, _, centres = projected_runs
    idx = [k.index for k in js.vo.keyframes]
    assert [k.index for k in ts.vo.keyframes] == idx and len(idx) >= 3
    ate_j = jate(js.keyframe_trajectory(), centres[idx])
    ate_t = tate(ts.keyframe_trajectory(), centres[idx])
    extent = float(np.abs(centres).max())
    print(f"keyframe ATE: JAX {ate_j:.6g}, port {ate_t:.6g} (extent "
          f"{extent:.3g})")
    assert np.isfinite(ate_t) and abs(ate_t - ate_j) <= 1e-3 * extent


# --------------------------------------------------------------------------
# checkpoints shared between the packages
# --------------------------------------------------------------------------

def _assert_same_map(a, b):
    """Keyframes, features, edges, trajectory and VO state of two systems
    (either package) equal."""
    def np_(v):
        if isinstance(v, torch.Tensor):
            return (words_to_numpy(v) if v.dim() == 2 and v.shape[1] == 16
                    else v.numpy())
        return np.asarray(v)

    assert len(a.vo.keyframes) == len(b.vo.keyframes)
    for ka, kb in zip(a.vo.keyframes, b.vo.keyframes):
        assert ka.index == kb.index
        np.testing.assert_array_equal(ka.R, kb.R)
        np.testing.assert_array_equal(ka.t, kb.t)
        # a keyframe without depths is stored as zeros, all invalid
        n = np_(ka.features.x).shape[0]
        for za, zb, dtype in ((ka.z, kb.z, np.float32),
                              (ka.z_ok, kb.z_ok, bool)):
            np.testing.assert_array_equal(
                np.zeros(n, dtype) if za is None else za,
                np.zeros(n, dtype) if zb is None else zb)
        for f in ("x", "y", "size", "layer", "response", "angle", "words",
                  "valid", "count"):
            va, vb = np_(getattr(ka.features, f)), np_(getattr(kb.features, f))
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb)
    assert len(a.edges) == len(b.edges)
    for ea, eb in zip(a.edges, b.edges):
        # weights are stored as float32
        assert (ea[0], ea[1], np.float32(ea[4])) == (eb[0], eb[1],
                                                     np.float32(eb[4]))
        np.testing.assert_array_equal(ea[2], eb[2])
        np.testing.assert_array_equal(ea[3], eb[3])
    np.testing.assert_array_equal(a.keyframe_trajectory(),
                                  b.keyframe_trajectory())
    np.testing.assert_array_equal(a.vo.trajectory(), b.vo.trajectory())
    np.testing.assert_array_equal(np.asarray(a.vo._key, np.uint32),
                                  np.asarray(b.vo._key, np.uint32))
    for attr in ("_frame_idx", "_kf_inliers0", "_scale", "_last_depth_med",
                 "overflow_frames"):
        assert getattr(a.vo, attr) == getattr(b.vo, attr), attr
    assert (a._n_kf_seen, a._since_opt) == (b._n_kf_seen, b._since_opt)
    np.testing.assert_allclose(np.stack(a.index._sigs),
                               np.stack(b.index._sigs), atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(image_runs, tmp_path, writer):
    js, ts, _ = image_runs
    p = str(tmp_path / "map.npz")
    if writer == "jax":
        js.save(p)
        fresh = tsys.SlamSystem(todo.Intrinsics(**IMG_INTR),
                                config_from(JConfig(**AKAZE_CFG)),
                                device="cpu")
        src = js
    else:
        ts.save(p)
        fresh = jsys.SlamSystem(jodo.Intrinsics(**IMG_INTR),
                                JConfig(**AKAZE_CFG))
        src = ts
    fresh.restore(p)
    _assert_same_map(fresh, src)
    # the geometry-only restore reads the same file
    fresh.restore_poses(p)
    _assert_same_map(fresh, src)


def test_restored_port_system_keeps_tracking(image_runs, tmp_path):
    js, _, _ = image_runs
    p = str(tmp_path / "map.npz")
    js.save(p)
    fresh = tsys.SlamSystem(todo.Intrinsics(**IMG_INTR),
                            config_from(JConfig(**AKAZE_CFG)),
                            tsys.SlamConfig(**SLAM_CFG), device="cpu",
                            **VO_CFG)
    fresh.restore(p)
    n = len(fresh.vo.keyframes)
    R, t = fresh.process(image_sequence()[0][-2])
    assert np.isfinite(R).all() and np.isfinite(t).all()
    assert len(fresh.vo.keyframes) == n + 1
    assert fresh.vo._frame_idx == js.vo._frame_idx + 1


def test_entry_points_default_to_the_card():
    intr = todo.Intrinsics(**IMG_INTR)
    if torch.cuda.is_available():
        assert tsys.SlamSystem(intr).device.type == "cuda"
        assert todo.VisualOdometry(intr).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tsys.SlamSystem(intr)
        with pytest.raises(RuntimeError):
            todo.VisualOdometry(intr, AkazeConfig(max_pts=64))
