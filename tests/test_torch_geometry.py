"""The PyTorch port's geometry (SE(3), epipolar geometry, RANSAC) and
dataset utilities against the JAX package, on the same seeded inputs.

Tolerances (float32 on both sides; the two frameworks round matrix
products and transcendental functions differently):
  - so3/se3 exp and log, inverse, compose, apply: 1e-6 absolute, and 1e-5
    for logs near pi (where the axis comes from a square root);
  - derivatives at xi = 0: finite and within 1e-6 of ``jax.jacfwd``;
  - the 8-point E (unit Frobenius norm, sign free): 1e-3 per entry on 60
    points, 2e-2 on minimal sets whose A is conditioned well enough for
    float32 (see the test); Sampson errors within 1e-5 relative or 1e-9
    absolute (inlier thresholds are 1e-5..1e-4); poses recovered from one
    E: 1e-5, cheirality masks equal;
  - RANSAC on the JAX package's own [K, 8] draws: E up to sign within 2e-3,
    R and t within 1e-3 (noise-free case: 2e-2 and 2e-2, where the winning
    set is ill-conditioned; both packages are then as far from the true
    pose), inlier counts equal, inlier masks equal except rows whose
    Sampson error lies within 1e-3 relative of the threshold (none on
    these inputs);
  - the dataset utilities exactly (frames byte for byte, files equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.geometry import epipolar as jepi
from akaze_tpu.geometry import ransac as jransac
from akaze_tpu.geometry import se3 as jse3
from akaze_tpu.io import dataset as jdata
from akaze_tpu_torch.geometry import epipolar as tepi
from akaze_tpu_torch.geometry import ransac as transac
from akaze_tpu_torch.geometry import se3 as tse3
from akaze_tpu_torch.io import dataset as tdata
from test_geometry import make_two_view

torch.set_num_threads(1)


class _Jitted:
    """A module's functions, each called through ``jax.jit`` (one compile
    per function and shape rather than one per primitive)."""

    def __init__(self, mod, static=()):
        self._mod = mod
        self._static = static

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if not callable(fn):
            return fn
        return jax.jit(fn, static_argnums=self._static)


jse3 = _Jitted(jse3)
jepi = _Jitted(jepi)


def t_(a):
    return torch.from_numpy(np.array(a))


def rotvecs(rng, n, lo, hi):
    w = rng.standard_normal((n, 3))
    w *= rng.uniform(lo, hi, (n, 1)) / np.linalg.norm(w, axis=1,
                                                     keepdims=True)
    return w.astype(np.float32)


def same_up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return b * np.sign(np.sum(a * b))


# --------------------------------------------------------------------------
# se3
# --------------------------------------------------------------------------

@pytest.mark.parametrize("regime,lo,hi,tol", [
    ("regular", 0.01, 3.0, 1e-6),
    ("near zero", 1e-7, 1e-3, 1e-6),
    ("near pi", np.pi - 1e-3, np.pi - 1e-6, 1e-5),
])
def test_so3_exp_log_match_jax(rng, regime, lo, hi, tol):
    w = rotvecs(rng, 64, lo, hi)
    Rj = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    Rt = tse3.so3_exp(t_(w)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6, err_msg=regime)
    lj = np.asarray(jse3.so3_log(jnp.asarray(Rj)))
    lt = tse3.so3_log(t_(Rj)).numpy()
    np.testing.assert_allclose(lt, lj, atol=tol, err_msg=regime)
    # the round trip itself, as the JAX package's test holds it
    np.testing.assert_allclose(lt, w, atol=2e-3 if regime == "near pi"
                               else 2e-4)


@pytest.mark.parametrize("scale", [1e-4, 0.8, 3.0])
def test_se3_exp_log_match_jax(rng, scale):
    xi = (rng.standard_normal((32, 6)) * scale).astype(np.float32)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(t_(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6 * max(
        1.0, scale))
    lj = np.asarray(jse3.se3_log(Rj, tj))
    lt = tse3.se3_log(t_(Rj), t_(tj)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-5 * max(1.0, scale))


def test_se3_inverse_compose_apply_match_jax(rng):
    xa = (rng.standard_normal((8, 6))).astype(np.float32)
    xb = (rng.standard_normal((8, 6))).astype(np.float32)
    p = rng.standard_normal((8, 3)).astype(np.float32)
    Ra, ta = (np.asarray(v) for v in jse3.se3_exp(jnp.asarray(xa)))
    Rb, tb = (np.asarray(v) for v in jse3.se3_exp(jnp.asarray(xb)))
    pairs = [
        (jse3.se3_inverse(Ra, ta), tse3.se3_inverse(t_(Ra), t_(ta))),
        (jse3.se3_compose(Ra, ta, Rb, tb),
         tse3.se3_compose(t_(Ra), t_(ta), t_(Rb), t_(tb))),
        ((jse3.se3_apply(Ra, ta, p),), (tse3.se3_apply(t_(Ra), t_(ta),
                                                       t_(p)),)),
        (jse3._mod.se3_identity((4,)), tse3.se3_identity((4,))),
        ((jse3.hat(p), jse3.vee(jse3.hat(p))),
         (tse3.hat(t_(p)), tse3.vee(tse3.hat(t_(p))))),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def _edge_residual_j(xi):
    """An SE(3) residual of the pose-graph form, log(M^-1 exp(xi)), in
    JAX; xi [1, 6]."""
    Rm, tm = jse3.se3_exp(jnp.asarray([[0.3, -0.2, 0.1, 0.05, 0.02, -0.1]],
                                      jnp.float32))
    R, t = jse3.se3_exp(xi)
    Ri, ti = jse3.se3_inverse(Rm, tm)
    return jse3.se3_log(*jse3.se3_compose(Ri, ti, R, t))


def _edge_residual_t(xi):
    Rm, tm = tse3.se3_exp(torch.tensor([[0.3, -0.2, 0.1, 0.05, 0.02, -0.1]]))
    R, t = tse3.se3_exp(xi)
    Ri, ti = tse3.se3_inverse(Rm, tm)
    return tse3.se3_log(*tse3.se3_compose(Ri, ti, R, t))


@pytest.mark.parametrize("name", ["exp-log", "so3 log", "edge residual"])
def test_jacobian_at_zero_is_finite_and_matches_jax(name):
    fns = {
        "exp-log": (lambda x: tse3.se3_log(*tse3.se3_exp(x)),
                    lambda x: jse3.se3_log(*jse3.se3_exp(x))),
        "so3 log": (lambda x: tse3.so3_log(tse3.so3_exp(x[:, 3:])),
                    lambda x: jse3.so3_log(jse3.so3_exp(x[:, 3:]))),
        "edge residual": (_edge_residual_t, _edge_residual_j),
    }
    ft, fj = fns[name]
    jt = torch.func.jacfwd(ft)(torch.zeros(1, 6)).numpy()
    jj = np.asarray(jax.jit(jax.jacfwd(fj))(jnp.zeros((1, 6), jnp.float32)))
    assert np.isfinite(jt).all()
    np.testing.assert_allclose(jt, jj, atol=1e-6)


# --------------------------------------------------------------------------
# epipolar
# --------------------------------------------------------------------------

def test_essential_from_eight_matches_jax(rng):
    x1, x2, *_ = make_two_view(rng, n=60)
    Ej = np.asarray(jepi.essential_from_eight(jnp.asarray(x1),
                                              jnp.asarray(x2)))
    Et = tepi.essential_from_eight(t_(x1), t_(x2)).numpy()
    np.testing.assert_allclose(same_up_to_sign(Ej, Et), Ej, atol=1e-3)
    # batched minimal sets of distinct rows (as RANSAC calls it), each up
    # to sign.  The eigenvector of A^T A is as ill-posed in float32 as A is
    # conditioned (A^T A squares it): sets with sigma_8 / sigma_1 of A
    # (float64) of at least 1e-3 are held to 2e-2; for worse sets both
    # solvers return float32 noise, which must still be finite.
    idx = np.stack([rng.permutation(60)[:8] for _ in range(64)])
    Ej = np.asarray(jepi.essential_from_eight(jnp.asarray(x1[idx]),
                                              jnp.asarray(x2[idx])))
    Et = tepi.essential_from_eight(t_(x1[idx]), t_(x2[idx])).numpy()
    s = np.sign(np.sum(Ej * Et, axis=(1, 2)))[:, None, None]
    h1 = np.concatenate([x1[idx], np.ones((64, 8, 1))], -1)
    h2 = np.concatenate([x2[idx], np.ones((64, 8, 1))], -1)
    sv = np.linalg.svd((h2[..., :, None] * h1[..., None, :]).reshape(
        64, 8, 9), compute_uv=False)
    posed = sv[:, -1] / sv[:, 0] >= 1e-3
    assert posed.sum() >= 8 and np.isfinite(Et).all()
    np.testing.assert_allclose((Et * s)[posed], Ej[posed], atol=2e-2)
    err_j = np.asarray(jepi.sampson_error(jnp.asarray(Ej), jnp.asarray(x1),
                                          jnp.asarray(x2)))
    err_t = tepi.sampson_error(t_(Ej), t_(x1), t_(x2)).numpy()
    np.testing.assert_allclose(err_t, err_j, rtol=1e-5, atol=1e-9)


def test_duplicate_picks_still_score(rng):
    """A minimal set with repeated rows leaves A^T A rank-deficient: the
    hypothesis must stay finite and score (as in the JAX package)."""
    x1, x2, *_ = make_two_view(rng, n=30)
    idx = np.asarray([[0, 0, 1, 1, 2, 2, 3, 3]])
    E = tepi.essential_from_eight(t_(x1[idx]), t_(x2[idx]))
    err = tepi.sampson_error(E, t_(x1)[None], t_(x2)[None])
    assert torch.isfinite(E).all() and torch.isfinite(err).all()


def test_decompose_triangulate_recover_match_jax(rng):
    x1, x2, R, t, X = make_two_view(rng, n=80)
    E = np.asarray(jepi.essential_from_eight(jnp.asarray(x1),
                                             jnp.asarray(x2)))
    Rs_j, ts_j = (np.asarray(v) for v in jepi.decompose_essential(E))
    Rs_t, ts_t = tepi.decompose_essential(t_(E))
    # the SVD's signs are free: the same four candidates, in some order
    for Rg, tg in zip(Rs_t.numpy(), ts_t.numpy()):
        d = [max(np.abs(Rg - Rw).max(), np.abs(tg - tw).max())
             for Rw, tw in zip(Rs_j, ts_j)]
        assert min(d) < 1e-5
    Xj, z1j, z2j = jepi.triangulate(jnp.asarray(R), jnp.asarray(t),
                                    jnp.asarray(x1), jnp.asarray(x2))
    Xt, z1t, z2t = tepi.triangulate(t_(R), t_(t), t_(x1), t_(x2))
    for g, w in ((Xt, Xj), (z1t, z1j), (z2t, z2j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    mask = rng.random(80) > 0.2
    Rj, tj, gj = jepi.recover_pose(jnp.asarray(E), jnp.asarray(x1),
                                   jnp.asarray(x2), jnp.asarray(mask))
    Rt, tt, gt = tepi.recover_pose(t_(E), t_(x1), t_(x2), t_(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


# --------------------------------------------------------------------------
# RANSAC
# --------------------------------------------------------------------------

# one shape for every case: one compile of the JAX program
RANSAC_CASES = {
    "outliers 35%": dict(n=200, noise=5e-4, outlier_frac=0.35, seed=3,
                         masked=False),
    "masked rows": dict(n=200, noise=1e-4, outlier_frac=0.0, seed=0,
                        masked=True),
    "noise-free": dict(n=200, noise=0.0, outlier_frac=0.2, seed=5,
                       masked=False, tol=(2e-2, 2e-2)),
}


def _ransac_inputs(rng, c):
    x1, x2, R, t, _ = make_two_view(rng, n=c["n"], noise=c["noise"],
                                    outlier_frac=c["outlier_frac"])
    valid = np.ones(c["n"], bool)
    if c["masked"]:
        half = c["n"] // 2
        x2[half:] = rng.uniform(-1, 1, (c["n"] - half, 2)).astype(np.float32)
        valid[half:] = False
    return x1, x2, valid, R, t


@pytest.mark.parametrize("case", sorted(RANSAC_CASES))
def test_ransac_on_jax_draws_matches_jax(rng, case):
    c = RANSAC_CASES[case]
    x1, x2, valid, R, t = _ransac_inputs(rng, c)
    key = jax.random.PRNGKey(c["seed"])
    thr = 5e-5
    res_j = jransac.ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(valid), threshold=thr,
                                     num_hyps=512)
    sets = np.asarray(jax.jit(jransac._sample_minimal_sets,
                              static_argnums=(2, 3))(
        key, jnp.asarray(valid), 512, 8))
    res_t = transac.ransac_essential(None, t_(x1), t_(x2), t_(valid),
                                     threshold=thr, num_hyps=512,
                                     sets=t_(sets))
    tol_e, tol_rt = c.get("tol", (2e-3, 1e-3))
    Ej, Et = np.asarray(res_j.E), res_t.E.numpy()
    np.testing.assert_allclose(same_up_to_sign(Ej, Et), Ej, atol=tol_e)
    np.testing.assert_allclose(res_t.R.numpy(), np.asarray(res_j.R),
                               atol=tol_rt)
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t),
                               atol=tol_rt)
    # no farther from the true pose than the JAX package's answer
    t_unit = t / np.linalg.norm(t)
    for got, want, true in ((res_t.R.numpy(), np.asarray(res_j.R), R),
                            (res_t.t.numpy(), np.asarray(res_j.t), t_unit)):
        assert (np.abs(got - true).max()
                <= np.abs(want - true).max() + tol_rt)
    # inlier masks: equal, except rows within float noise of the threshold
    err = np.asarray(jepi.sampson_error(jnp.asarray(Ej), jnp.asarray(x1),
                                        jnp.asarray(x2)))
    near = np.abs(err - thr) < 1e-3 * thr
    differ = np.asarray(res_j.inliers) != res_t.inliers.numpy()
    assert not (differ & ~near).any()
    assert differ.sum() == 0
    assert int(res_t.num_inliers) == int(res_j.num_inliers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_own_draw_meets_the_jax_tests_bars(rng, seed):
    """The port's own draw passes the statistical bars of
    tests/test_geometry.py::TestRansac."""
    x1, x2, R, t, _ = make_two_view(rng, n=200, noise=5e-4,
                                    outlier_frac=0.35)
    gen = torch.Generator().manual_seed(seed)
    res = transac.ransac_essential(gen, t_(x1), t_(x2),
                                   torch.ones(200, dtype=torch.bool),
                                   threshold=5e-5, num_hyps=512)
    assert int(res.num_inliers) > 100
    np.testing.assert_allclose(res.R.numpy(), R, atol=0.02)
    cos = abs(float(np.dot(res.t.numpy(), t / np.linalg.norm(t))))
    assert cos > 0.99

    x1, x2, valid, R, t = _ransac_inputs(
        rng, dict(RANSAC_CASES["masked rows"], n=100))
    res = transac.ransac_essential(gen, t_(x1), t_(x2), t_(valid),
                                   threshold=5e-5, num_hyps=256)
    inl = res.inliers.numpy()
    assert not inl[50:].any()
    assert inl[:50].sum() > 35


def test_draw_is_uniform_over_valid_rows_and_in_range():
    gen = torch.Generator().manual_seed(0)
    mask = torch.zeros(40, dtype=torch.bool)
    sets = transac.draw_minimal_sets(gen, mask, 16)
    assert sets.shape == (16, 8) and int(sets.min()) >= 0
    assert int(sets.max()) < 40                      # no valid row: in range
    mask[[3, 7, 8, 30]] = True
    sets = transac.draw_minimal_sets(gen, mask, 4000)
    counts = np.bincount(sets.flatten().numpy(), minlength=40)
    assert set(np.nonzero(counts)[0]) == {3, 7, 8, 30}
    # 32000 draws, 8000 expected per row: within 5 standard deviations
    assert np.abs(counts[[3, 7, 8, 30]] - 8000).max() < 5 * np.sqrt(6000)
    # one key gives one draw; split keys give others
    key = transac.make_key(5)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(5)))
    a = transac.sets_from_key(key, mask, 8)
    assert torch.equal(a, transac.sets_from_key(key, mask, 8))
    nxt, sub = transac.split_key(key)
    assert not np.array_equal(nxt, sub) and nxt.dtype == np.uint32
    assert not torch.equal(a, transac.sets_from_key(sub, mask, 8))


# --------------------------------------------------------------------------
# io.dataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(n_frames=4, size=(60, 80), shift_per_frame=(2.0, 3.0), n_blobs=20),
    dict(n_frames=3, size=(48, 64), shift_per_frame=(0.0, -5.5),
         n_blobs=12),
])
def test_synthetic_sequence_equals_jax(args):
    fj, oj = jdata.synthetic_sequence(np.random.default_rng(11), **args)
    ft, ot = tdata.synthetic_sequence(np.random.default_rng(11), **args)
    assert fj.dtype == ft.dtype == np.uint8
    assert fj.tobytes() == ft.tobytes()
    np.testing.assert_array_equal(ot, oj)


def test_ate_and_kitti_files_equal_jax(rng, tmp_path):
    est = rng.standard_normal((12, 3))
    gt = est * 1.7 @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.3
    gt = gt + rng.standard_normal(gt.shape) * 0.01
    for align in (True, False):
        assert tdata.ate_rmse(est, gt, align) == jdata.ate_rmse(est, gt,
                                                                align)
    R = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0]
                  for _ in range(5)]).astype(np.float32)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
    jdata.save_kitti_poses(str(pj), R, t)
    tdata.save_kitti_poses(str(pt), R, t)
    assert pj.read_bytes() == pt.read_bytes()
    for a, b in zip(tdata.load_kitti_poses(str(pj)),
                    jdata.load_kitti_poses(str(pj))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_frame_sequence_reads_the_port_io(tmp_path):
    from akaze_tpu_torch.io import save_pgm
    frames, _ = tdata.synthetic_sequence(np.random.default_rng(1),
                                         n_frames=3, size=(20, 30),
                                         n_blobs=5)
    for k, f in enumerate(frames):
        save_pgm(str(tmp_path / f"{k:06d}.pgm"), f)
    seq = tdata.FrameSequence(str(tmp_path))
    assert len(seq) == 3
    for got, want in zip(seq, frames):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tdata.FrameSequence(str(tmp_path / "none*.pgm"))
