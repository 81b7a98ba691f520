"""The PyTorch port's homography and DLT PnP (``geometry/homography.py``)
against the JAX package's, on the same seeded inputs (the cases of
tests/test_geometry.py).

Tolerances (float32 on both sides; ``eigh`` leaves each eigenvector's
sign free, so H is compared up to sign and scale):
  - H after unit Frobenius normalisation and sign alignment: 1e-4 per entry
    (measured 2e-5 on 40 exact points, 4e-6 with zero weights, 2e-6 after
    RANSAC);
  - transfer errors: 1e-7 squared px absolute on exact points (both sides
    ~1e-9..1e-8, float32 noise of pixel coordinates), equal within 1e-6
    relative where a point maps to |z| < 1e-12;
  - RANSAC on the JAX package's own [K, 4] draws: inlier masks equal except
    rows whose transfer error lies within 1e-3 relative of the threshold
    (none on this input), counts equal to the masks' sums;
  - PnP: R within 1e-3 and t within 1e-2 (the JAX test's bars against the
    true pose; the two packages measured 1.2e-4 and 1.1e-3 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.geometry import homography as jh
from akaze_tpu.geometry.ransac import _sample_minimal_sets
from akaze_tpu_torch.geometry import homography as th
from akaze_tpu_torch.testing import (H_OUTLIERS, homography_distance,
                                     homography_outlier_case)
from test_geometry import random_rotation

torch.set_num_threads(1)

H_TOL = 1e-4


def t_(a):
    return torch.from_numpy(np.array(a))


def assert_same_homography(got, want, tol=H_TOL):
    """Equal up to sign and scale: unit Frobenius norm, sign aligned."""
    d = homography_distance(got, want)
    assert d <= tol, f"homographies differ by {d} (tolerance {tol})"


def exact_case(rng, n=40):
    """tests/test_geometry.py::TestHomography::test_exact_recovery."""
    H_true = np.asarray([[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0],
                         [1e-4, -2e-4, 1.0]])
    x1 = rng.uniform(0, 100, (n, 2))
    h = np.concatenate([x1, np.ones((n, 1))], 1) @ H_true.T
    x2 = h[:, :2] / h[:, 2:3]
    return x1.astype(np.float32), x2.astype(np.float32), H_true


def pnp_case(rng):
    """tests/test_geometry.py::TestPnP::test_dlt_pnp_recovers_pose."""
    Xw = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3)).astype(np.float32)
    R_true = random_rotation(rng)
    t_true = np.asarray([0.3, -0.2, 0.5], np.float32)
    Xc = Xw @ R_true.T + t_true
    if (Xc[:, 2] <= 0.1).any():
        t_true = t_true + np.asarray([0, 0, 12], np.float32)
        Xc = Xw @ R_true.T + t_true
    u = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    return Xw, u, R_true, t_true


@pytest.mark.parametrize("scale", [1.0, -3.5])
def test_homography_distance_ignores_sign_and_scale(scale):
    """The shared comparison (``akaze_tpu_torch.testing``): 0 for the same
    H up to sign and scale, the entry change otherwise."""
    H = H_OUTLIERS / np.linalg.norm(H_OUTLIERS)
    assert homography_distance(scale * H, H) < 1e-15
    moved = H.copy()
    moved[2, 0] += 1e-3
    assert homography_distance(scale * moved, H) > 5e-4


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_from_points_matches_jax(rng, weighted):
    x1, x2, H_true = exact_case(rng)
    w = None
    if weighted:
        w = (rng.random(len(x1)) > 0.3).astype(np.float32)
        assert 0 < w.sum() < len(w)          # some rows weigh nothing
    Hj = jh.homography_from_points(jnp.asarray(x1), jnp.asarray(x2),
                                   None if w is None else jnp.asarray(w))
    Ht = th.homography_from_points(t_(x1), t_(x2),
                                   None if w is None else t_(w))
    assert Ht.dtype == torch.float32 and Ht.shape == (3, 3)
    assert_same_homography(Ht.numpy(), Hj)
    assert_same_homography(Ht.numpy(), H_true)
    ej = np.asarray(jh.homography_transfer_error(Hj, jnp.asarray(x1),
                                                 jnp.asarray(x2)))
    et = th.homography_transfer_error(Ht, t_(x1), t_(x2)).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-7)


def test_hartley_zero_weights_stay_finite(rng):
    """All weights zero: T and H finite (the 1e-6 and 1e-12 guards), as in
    the JAX package."""
    x1, x2, _ = exact_case(rng, n=8)
    w = np.zeros(8, np.float32)
    _, T, Tinv = th._hartley(t_(x1), t_(w))
    assert torch.isfinite(T).all() and torch.isfinite(Tinv).all()
    H = th.homography_from_points(t_(x1), t_(x2), t_(w))
    Hj = jh.homography_from_points(jnp.asarray(x1), jnp.asarray(x2),
                                   jnp.asarray(w))
    assert torch.isfinite(H).all() and np.isfinite(np.asarray(Hj)).all()


def test_transfer_error_matches_jax_batched_and_at_z_zero(rng):
    """[K, 3, 3] against [1, N, 2] broadcasting, and points that H maps to
    z = 0 (divided by 1e-12 on both sides)."""
    x1, x2, H_true = exact_case(rng)
    x1[:3, 0] = 100.0                 # z = 0.01 * 100 - 1 = 0 below
    Hs = np.stack([H_true, [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                            [0.01, 0.0, -1.0]]]).astype(np.float32)
    ej = np.asarray(jh.homography_transfer_error(
        jnp.asarray(Hs), jnp.asarray(x1)[None], jnp.asarray(x2)[None]))
    et = th.homography_transfer_error(t_(Hs), t_(x1)[None],
                                      t_(x2)[None]).numpy()
    assert et.shape == ej.shape == (2, len(x1))
    assert (et[1, :3] > 1e20).all()
    np.testing.assert_allclose(et, ej, rtol=1e-6, atol=1e-7)


def test_ransac_on_jax_draws_matches_jax(rng):
    x1, x2, _ = homography_outlier_case(rng)
    key = jax.random.PRNGKey(1)
    valid = np.ones(len(x1), bool)
    want = jh.ransac_homography(key, jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(valid), threshold=4.0,
                                num_hyps=256)
    sets = np.asarray(_sample_minimal_sets(key, jnp.asarray(valid), 256, 4))
    got = th.ransac_homography(None, t_(x1), t_(x2), t_(valid),
                               threshold=4.0, num_hyps=256, sets=t_(sets))
    assert_same_homography(got.H.numpy(), want.H)
    gi, wi = got.inliers.numpy(), np.asarray(want.inliers)
    err = th.homography_transfer_error(got.H, t_(x1), t_(x2)).numpy()
    near = np.abs(err - 4.0) < 4e-3
    assert not near.any()             # no row within noise of the bar
    np.testing.assert_array_equal(gi, wi)
    assert got.num_inliers.dtype == torch.int32
    assert int(got.num_inliers) == int(gi.sum()) == int(want.num_inliers)


def test_ransac_own_draw_meets_the_jax_tests_bars(rng):
    """The port's draw (a seeded generator; no JAX sets): the bars of
    tests/test_geometry.py::test_ransac_with_outliers."""
    x1, x2, out = homography_outlier_case(rng)
    gen = torch.Generator().manual_seed(1)
    res = th.ransac_homography(gen, t_(x1), t_(x2),
                               torch.ones(len(x1), dtype=torch.bool),
                               threshold=4.0, num_hyps=256)
    assert int(res.num_inliers) > 85
    assert int(res.inliers.numpy()[out].sum()) < 5


def _raw_depth_sign(X, u):
    """Depth majority of the DLT system's first eigenvector, before the sign
    fix, as each package's ``eigh`` returns it."""
    Xh = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    z = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([Xh, z, -u[:, :1] * Xh], 1),
                        np.concatenate([z, Xh, -u[:, 1:] * Xh], 1)], 0)
    AtA = A.T @ A
    signs = []
    for p in (torch.linalg.eigh(t_(AtA))[1][:, 0].numpy(),
              np.asarray(jnp.linalg.eigh(jnp.asarray(AtA))[1][:, 0])):
        p = p.reshape(3, 4)
        signs.append(np.sign(X @ p[:, :3].T + p[:, 3])[:, 2].sum())
    return signs


@pytest.mark.parametrize("case", ["jax_test", "weighted",
                                  "negative_depth_majority"])
def test_pnp_dlt_matches_jax(rng, case):
    if case == "negative_depth_majority":
        # seed 3 of this generator: both packages' first eigenvector has
        # every depth negative, so the sign fix runs on both sides
        X, u, R_true, t_true = pnp_case(np.random.default_rng(3))
        assert _raw_depth_sign(X, u) == [-30.0, -30.0]
    else:
        X, u, R_true, t_true = pnp_case(rng)
    w = None
    if case == "weighted":
        w = rng.uniform(0.5, 1.5, len(X)).astype(np.float32)
        w[::7] = 0.0
    Rj, tj = jh.pnp_dlt(jnp.asarray(X), jnp.asarray(u),
                        None if w is None else jnp.asarray(w))
    Rt, tt = th.pnp_dlt(t_(X), t_(u), None if w is None else t_(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-2)
    np.testing.assert_allclose(Rt.numpy(), R_true, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), t_true, rtol=0, atol=1e-2)
    assert abs(float(torch.linalg.det(Rt)) - 1.0) < 1e-5


def test_geometry_exports():
    import akaze_tpu.geometry as jg
    import akaze_tpu_torch.geometry as tg
    assert sorted(tg.__all__) == sorted(jg.__all__)
    assert tg.ransac_homography is th.ransac_homography
