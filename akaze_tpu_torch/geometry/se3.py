"""SO(3) / SE(3) Lie-group operations on batched tensors.

Port of ``akaze_tpu/geometry/se3.py``.  Poses are (R, t) with R [..., 3, 3]
rotation matrices and t [..., 3] translations; every function accepts
arbitrary leading batch dimensions.

Numerics: exp/log use the Rodrigues forms with Taylor branches near
theta = 0, and every branch sees only inputs it is safe (and
differentiable) on, so that ``torch.func`` derivatives at exactly 0 stay
finite: the pose-graph solver linearises at xi = 0.  A ``torch.where`` of
unguarded branches would carry a NaN derivative from the branch not taken.
Differentiate with a leading batch axis (``xi`` of shape [B, 6], not [6]):
PyTorch's forward-mode AD gives float64 tangents where a 0-dim float32
tensor meets a Python scalar.
"""

from __future__ import annotations

import torch

_EPS = 1e-8

# Small-angle switch: below this the closed forms lose all float32 precision
# ((1 - cos x) underflows to 0 for x < ~3.5e-4), while the Taylor forms are
# already accurate to ~1e-10.
_SMALL = 1e-2


def hat(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """[..., 3, 3] -> [..., 3], the inverse of hat."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3))


def _safe_norm(w, eps=1e-12):
    """||w|| with a zero (not NaN) derivative at w = 0."""
    n2 = torch.sum(w * w, dim=-1)
    small = n2 < eps
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, torch.zeros_like(n), n)


def _sinc(x):
    """sin(x)/x with a Taylor branch."""
    small = torch.abs(x) < _SMALL
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0,
                       torch.sin(xs) / xs)


def _cosc(x):
    """(1 - cos(x)) / x^2 with a Taylor branch."""
    small = torch.abs(x) < _SMALL
    xs = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0,
                       (1.0 - torch.cos(xs)) / (xs * xs))


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye(w) + a * W + b * W2


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle.

    Three regimes with input-guarded branches:
      small:   log = w_skew * (1 + |w_skew|^2 / 6),  w_skew = vee(R - R^T)/2
      regular: log = w_skew * theta / sin(theta)
      near pi: axis from the symmetric part, magnitude theta
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5     # sin(theta) * axis
    n2 = torch.sum(w_skew * w_skew, dim=-1)         # sin(theta)^2

    small = cos_t > 1.0 - 1e-4
    near_pi = cos_t < -1.0 + 1e-4
    regular = ~small & ~near_pi
    zero = torch.zeros_like(cos_t)
    one = torch.ones_like(cos_t)

    # regular branch: arccos and sqrt see guarded inputs only
    theta_r = torch.arccos(torch.where(regular, cos_t, zero))
    sin_safe = torch.sqrt(torch.where(regular, torch.clamp(n2, min=1e-20),
                                      one))
    w_reg = w_skew * (theta_r / sin_safe)[..., None]

    # small-angle branch: theta/sin(theta) = 1 + sin^2/6 + O(theta^4)
    w_small = w_skew * (1.0 + n2 / 6.0)[..., None]

    # near-pi branch: axis^2 from the diagonal of the symmetric part
    theta_pi = torch.arccos(torch.where(near_pi, cos_t, zero))
    B = (R + R.transpose(-1, -2)) * 0.5 - _eye(R[..., 0])
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    one_m_cos = torch.clamp(1.0 - cos_t, min=_EPS)[..., None]
    axis2 = torch.clamp(diag / one_m_cos + 1.0, min=0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None], axis2,
                                  torch.ones_like(axis2)))
    ones = torch.ones_like(w_skew)
    sign = torch.where(w_skew >= 0, ones, -ones)    # sign from the skew part
    axis = axis * sign
    axis = axis / torch.clamp(_safe_norm(axis)[..., None], min=_EPS)
    w_pi = axis * theta_pi[..., None]

    return torch.where(small[..., None], w_small,
                       torch.where(near_pi[..., None], w_pi, w_reg))


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (3, 3)).clone()
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    return R, t


def se3_exp(xi):
    """[..., 6] twist (v, w) -> (R [..., 3, 3], t [..., 3]).

    Convention: xi[..., :3] = translation part v, xi[..., 3:] = rotation w;
    t = V(w) v with the left Jacobian V.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    b = _cosc(theta)
    # c = (theta - sin theta) / theta^3, Taylor: 1/6 - theta^2/120
    small = theta < _SMALL
    ts = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(small, 1.0 / 6.0 - theta * theta / 120.0,
                    (ts - torch.sin(ts)) / (ts ** 3))
    V = _eye(w) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """(R, t) -> [..., 6] twist (v, w)."""
    w = so3_log(R)
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + (1/theta^2)(1 - sinc/(2 cosc)) W^2
    small = theta < _SMALL
    ts = torch.where(small, torch.ones_like(theta), theta)
    coef = torch.where(
        small, 1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - (_sinc(ts) / (2.0 * _cosc(ts)))) / (ts * ts))
    Vinv = _eye(w) - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, p):
    """Transform points p [..., 3] by (R, t)."""
    return (R @ p[..., None])[..., 0] + t
