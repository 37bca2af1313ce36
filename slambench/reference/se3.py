# Frozen copy of kintinuous_tpu_torch/geometry/se3.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""SE(3) utilities on torch tensors (port of kintinuous_tpu/geometry/se3.py).

Poses are 4x4 row-major matrices T = [[R, t], [0, 1]] mapping points
from the local frame into the parent frame. Twists are 6-vectors
[omega, v] (rotation first). Every function works on the device of
its input and broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def hat(w):
    """3-vector -> skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _rodrigues_coeffs(theta2):
    """sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks near zero (f32:
    Taylor beats the 1-cos cancellation below theta^2 = 1e-4)."""
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return small, a, b


def exp_so3(w):
    """Rodrigues' formula, exp: so(3) -> SO(3). Safe at theta ~ 0."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    _, a, b = _rodrigues_coeffs(theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R):
    """log: SO(3) -> so(3) (axis-angle vector). Safe near identity/pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_raw = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t + 1e-32)
    )
    w = w_raw * scale[..., None]
    # near pi the antisymmetric part vanishes; recover axis from diagonal
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-32), min=0.0
    )
    axis = torch.sqrt(axis2)
    sign = torch.sign(w_raw + 1e-32)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def exp_se3(xi):
    """exp: se(3) -> SE(3). xi = [omega, v] -> 4x4."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    small, a, b = _rodrigues_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    return make_T(R, t)


def log_se3(T):
    """log: SE(3) -> se(3) twist [omega, v]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    small, a, b = _rodrigues_coeffs(theta2)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / theta2
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def make_T(R, t):
    """Assemble 4x4 from (...,3,3) and (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the last row of the identity, made on the device: no copy from the
    # host, which a CUDA graph's capture does not allow
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def identity(dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device)


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, pts):
    """Apply (...,4,4) to points (...,N,3) or (...,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, torch.atleast_2d(pts)) + t[..., None, :]


def rotate_vectors(T, vecs):
    R = T[..., :3, :3]
    return torch.einsum("...ij,...nj->...ni", R, torch.atleast_2d(vecs))
