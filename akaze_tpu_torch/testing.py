"""Seeded cases and comparisons shared by the port's tests and
``chip_smoke.py`` (numpy only, no JAX), so that each is defined once.
"""

from __future__ import annotations

import numpy as np

# card against CPU on the same minimal sets: H (unit Frobenius norm, sign
# aligned) per entry
HOMOGRAPHY_CARD_TOL = 1e-3

# the known homography of tests/test_geometry.py::test_ransac_with_outliers
H_OUTLIERS = np.asarray([[0.9, 0.1, 5.0], [-0.1, 1.05, 2.0],
                         [2e-4, 1e-4, 1.0]])


def homography_outlier_case(rng, n=150, n_out=50):
    """Noisy matches of ``H_OUTLIERS`` with ``n_out`` planted outliers (the
    case of tests/test_geometry.py::test_ransac_with_outliers): float32
    ``x1``, ``x2`` [n, 2] and the outliers' row indices."""
    x1 = rng.uniform(0, 200, (n, 2))
    h = np.concatenate([x1, np.ones((n, 1))], 1) @ H_OUTLIERS.T
    x2 = h[:, :2] / h[:, 2:3]
    x2 += rng.standard_normal((n, 2)) * 0.3
    out = rng.choice(n, n_out, replace=False)
    x2[out] = rng.uniform(0, 200, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), out


def homography_distance(a, b) -> float:
    """Max entry difference of two homographies (arrays, or tensors on the
    CPU) after unit Frobenius normalisation and sign alignment: 0 when
    they are equal up to sign and scale."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return float(np.abs(a * np.sign(np.sum(a * b)) - b).max())
