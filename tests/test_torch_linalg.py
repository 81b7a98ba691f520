"""The port's sync-free solvers (``akaze_tpu_torch/geometry/linalg.py``)
against numpy's float64 ``eigh`` and ``svd``, on the CPU.

The solvers replace ``torch.linalg.eigh``/``svd`` inside the two-view and
homography programs; they compute in float64 and run the same sequence of
ops on the CPU and the card.  Eigenvectors and singular vectors are
compared up to sign (numpy's signs are LAPACK's), and the solvers' own
convention is checked: the largest-magnitude component of each returned
vector (of each column of V) is positive.

Tolerances (float64):
  - smallest eigenvector, up to sign: 1e-9 where the smallest eigenvalue
    is simple and at most a quarter of the next (8-point normal matrices of
    minimal and noisy sets, planted gaps down to 1e-6 of the largest
    eigenvalue); 1e-6 for float32 input and output;
  - close smallest eigenvalues (ratio l_1 / l_2 of 0.5 to 0.95), where the
    vector is tilted toward l_2's eigenvector: the Rayleigh quotient
    v^T M v within the solver's stated bound of numpy's l_1 (its docstring),
    plus 1e-13 of the trace for rounding; the tilt (the part orthogonal to
    l_1's eigenvector) within sqrt(9) (l_1 / l_2)^32, plus 1e-9;
  - null spaces of dimension 2, 3 and 9 (duplicate picks, the zero
    matrix), where any null vector is right: finite, unit within 1e-12,
    |M v| within 1e-9 of the trace;
  - ``svd3``: U diag(S) Vt within 1e-12 of the input's largest singular
    value, U and V orthonormal within 1e-12, S within 1e-12 of numpy's
    (relative to the largest), descending and non-negative; singular
    vectors up to sign within 1e-9 where every gap between singular values
    exceeds 1e-3 of the largest.  Repeated singular values (essential
    matrices, rotations, the zero matrix) are held by the reconstruction
    and orthonormality bounds, where every basis of the repeated space is
    right.
"""

import numpy as np
import pytest
import torch

from akaze_tpu_torch.geometry.linalg import smallest_eigenvector, svd3
from test_geometry import make_two_view

torch.set_num_threads(1)


def t_(a):
    return torch.from_numpy(np.array(a))


def gram(A):
    return np.einsum("...ni,...nj->...ij", A, A)


def eight_point_rows(x1, x2):
    h1 = np.concatenate([x1, np.ones(x1.shape[:-1] + (1,))], -1)
    h2 = np.concatenate([x2, np.ones(x2.shape[:-1] + (1,))], -1)
    return (h2[..., :, None] * h1[..., None, :]).reshape(x1.shape[:-1] + (9,))


def same_up_to_sign(got, want, axis=-1):
    s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return np.abs(got * np.where(s == 0, 1.0, s) - want).max()


def largest_component_positive(v, axis=-1):
    i = np.abs(v).argmax(axis=axis)
    return bool((np.take_along_axis(v, np.expand_dims(i, axis), axis)
                 > 0).all())


def planted(rng, n, second):
    """Symmetric 9x9 matrices with eigenvalues 0, ``second`` and 7 values
    in [0.1, 1], on random orthonormal bases; returns (M, the null
    vectors)."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, 9, 9)))
    lam = np.concatenate([[0.0, second], np.logspace(-1, 0, 7)])
    return np.einsum("bij,j,bkj->bik", Q, lam, Q), Q[..., 0]


def eig_case(name, rng):
    """(M, tolerance) of each well-posed case of the smallest eigenvector."""
    if name == "minimal sets":                     # rank 8, as RANSAC's
        return gram(rng.standard_normal((256, 8, 9))), 1e-9
    if name == "noisy 8-point systems":
        Ms = []
        for noise in (1e-4, 5e-4, 2e-3):
            x1, x2, *_ = make_two_view(rng, n=200, noise=noise)
            Ms.append(gram(eight_point_rows(x1.astype(np.float64),
                                            x2.astype(np.float64))))
        return np.stack(Ms), 1e-9
    gap = {"planted gap 1e-4": 1e-4, "planted gap 1e-6": 1e-6}[name]
    return planted(rng, 128, gap)[0], 1e-9


EIG_CASES = ["minimal sets", "noisy 8-point systems", "planted gap 1e-4",
             "planted gap 1e-6"]


@pytest.mark.parametrize("case", EIG_CASES)
def test_smallest_eigenvector_matches_numpy(rng, case):
    M, tol = eig_case(case, rng)
    w, V = np.linalg.eigh(M)
    assert (np.abs(w[..., 0]) <= 0.25 * w[..., 1]).all()  # a simple minimum
    got = smallest_eigenvector(t_(M))
    assert got.dtype == torch.float64 and got.shape == M.shape[:-1]
    got = got.numpy()
    assert same_up_to_sign(got, V[..., 0]) < tol
    assert largest_component_positive(got)
    # float32 in, float32 out (the 8-point and DLT callers' dtype)
    g32 = smallest_eigenvector(t_(M.astype(np.float32)))
    assert g32.dtype == torch.float32
    w32, V32 = np.linalg.eigh(M.astype(np.float32).astype(np.float64))
    assert same_up_to_sign(g32.numpy().astype(np.float64),
                           V32[..., 0]) < 1e-6


@pytest.mark.parametrize("ratio", [0.5, 0.8, 0.9, 0.95])
def test_smallest_eigenvector_on_close_eigenvalues(rng, ratio):
    """l_2 = l_1 / ratio: the Rayleigh quotient stays within the stated
    bound of l_1 even where the vector leans toward l_2's eigenvector."""
    Q, _ = np.linalg.qr(rng.standard_normal((256, 9, 9)))
    lam = np.concatenate([[1e-3, 1e-3 / ratio], np.logspace(-1, 0, 7)])
    M = np.einsum("bij,j,bkj->bik", Q, lam, Q)
    got = smallest_eigenvector(t_(M)).numpy()
    assert np.isfinite(got).all() and largest_component_positive(got)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)
    w = np.linalg.eigh(M)[0]
    trace = w.sum(-1)
    ridge = 1e-10 * trace[:, None]
    bound = 9 * ((w[:, 1:] - w[:, :1])
                 * ((w[:, :1] + ridge) / (w[:, 1:] + ridge)) ** 64).sum(-1)
    excess = np.einsum("bi,bij,bj->b", got, M, got) - w[:, 0]
    assert (excess <= bound + 1e-13 * trace).all()
    assert (excess >= -1e-13 * trace).all()
    along = np.einsum("bi,bi->b", got, Q[..., 0])[:, None] * Q[..., 0]
    tilt = np.linalg.norm(got - along, axis=-1)
    assert (tilt <= 3 * ratio ** 32 + 1e-9).all()


def null_case(name, rng):
    if name == "duplicate picks":          # test_duplicate_picks_still_score
        x1, x2, *_ = make_two_view(rng, n=30)
        idx = np.asarray([[0, 0, 1, 1, 2, 2, 3, 3], [0, 0, 0, 0, 1, 1, 2, 2],
                          [5, 5, 5, 5, 5, 5, 5, 5]])
        return gram(eight_point_rows(x1[idx].astype(np.float64),
                                     x2[idx].astype(np.float64)))
    if name == "zero":
        return np.zeros((3, 9, 9))
    k = {"null 2": 2, "null 3": 3}[name]
    return gram(rng.standard_normal((64, 9 - k, 9)))


@pytest.mark.parametrize("case", ["null 2", "null 3", "duplicate picks",
                                  "zero"])
def test_smallest_eigenvector_on_null_spaces(rng, case):
    """Any null vector is right: finite, unit, in the null space."""
    M = null_case(case, rng)
    got = smallest_eigenvector(t_(M)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)
    residual = np.linalg.norm(np.einsum("bij,bj->bi", M, got), axis=-1)
    trace = np.trace(M, axis1=-2, axis2=-1)
    assert (residual <= 1e-9 * np.maximum(trace, 1.0)).all()
    assert largest_component_positive(got)


def rotations(rng, n):
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def essential(rng, n):
    """[t]x R: singular values (|t|, |t|, 0)."""
    t = rng.standard_normal((n, 3))
    tx = np.zeros((n, 3, 3))
    tx[:, 0, 1], tx[:, 0, 2], tx[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    tx -= np.swapaxes(tx, -1, -2)
    return tx @ rotations(rng, n)


def svd_case(name, rng):
    if name == "random":
        return rng.standard_normal((1000, 3, 3))
    if name == "essential":
        return essential(rng, 500)
    if name == "essential, float32-rounded":
        return essential(rng, 500).astype(np.float32).astype(np.float64)
    if name == "essential + 1e-9 noise":
        E = essential(rng, 500)
        return E + 1e-9 * rng.standard_normal(E.shape)
    if name == "rank 1":
        return np.einsum("bi,bj->bij", rng.standard_normal((200, 3)),
                         rng.standard_normal((200, 3)))
    if name == "rotation":
        return rotations(rng, 200)
    return np.zeros((4, 3, 3))                               # "zero"


SVD_CASES = ["random", "essential", "essential, float32-rounded",
             "essential + 1e-9 noise", "rank 1", "rotation", "zero"]


@pytest.mark.parametrize("case", SVD_CASES)
def test_svd3_matches_numpy(rng, case):
    E = svd_case(case, rng)
    U, S, Vt = (x.numpy() for x in svd3(t_(E)))
    assert U.dtype == S.dtype == Vt.dtype == np.float64
    Un, Sn, Vtn = np.linalg.svd(E)
    scale = np.maximum(Sn[..., :1], 1e-300)
    assert all(np.isfinite(x).all() for x in (U, S, Vt))
    rec = np.einsum("bij,bj,bjk->bik", U, S, Vt) - E
    assert (np.abs(rec).max(axis=(-2, -1)) <= 1e-12 * scale[..., 0]
            + 1e-300).all()
    eye = np.eye(3)
    assert np.abs(np.swapaxes(U, -1, -2) @ U - eye).max() < 1e-12
    assert np.abs(Vt @ np.swapaxes(Vt, -1, -2) - eye).max() < 1e-12
    assert (np.abs(S - Sn) <= 1e-12 * scale).all()
    assert (S >= 0).all() and (np.diff(S, axis=-1) <= 1e-12 * scale).all()
    assert largest_component_positive(Vt, axis=-1)      # rows of Vt
    gap = np.minimum(Sn[:, 0] - Sn[:, 1], Sn[:, 1] - Sn[:, 2])
    simple = gap > 1e-3 * scale[:, 0]
    if case == "random":
        assert simple.mean() > 0.9
    if simple.any():
        assert same_up_to_sign(Vt[simple], Vtn[simple]) < 1e-9
        assert same_up_to_sign(np.swapaxes(U[simple], -1, -2),
                               np.swapaxes(Un[simple], -1, -2)) < 1e-9


def test_svd3_keeps_float32():
    rng = np.random.default_rng(1)
    E = essential(rng, 64).astype(np.float32)
    U, S, Vt = svd3(t_(E))
    assert U.dtype == S.dtype == Vt.dtype == torch.float32
    Sn = np.linalg.svd(E.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(S.numpy(), Sn, atol=1e-6 * Sn.max())
