"""SO(3) quaternion algebra for the plain references, in plain PyTorch.

A frozen copy of the formulas the program under test uses (quaternions
``[w, x, y, z]``, Hamilton, active rotation; right-multiplicative
retraction ``q ⊞ δθ = q ⊗ exp(δθ)``), kept here so that the yardstick does
not move when the program's own module changes. Every function is
shape-polymorphic over leading batch dims and safe under
``torch.func.vmap`` / ``jacfwd``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting leading dims."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _sign_w(q: torch.Tensor) -> torch.Tensor:
    """-1 where the quaternion's w < 0, else +1 (shape [..., 1])."""
    return 1.0 - 2.0 * (q[..., 0:1] < 0).to(q.dtype)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix. (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


# ----------------------------------------------------------------------------
# Quaternion algebra ([w, x, y, z])
# ----------------------------------------------------------------------------


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b. (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v. (...,4),(...,3)->(...,3).

    Uses the 15-mul expansion rather than forming the rotation matrix.
    """
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


# ----------------------------------------------------------------------------
# SO(3) exp/log and Jacobians
# ----------------------------------------------------------------------------


def so3_exp_quat(w: torch.Tensor) -> torch.Tensor:
    """exp: so(3) -> unit quaternion. (..., 3) -> (..., 4). Taylor-safe
    near zero."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    # sin(t/2)/t with Taylor fallback 1/2 - t^2/48.
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """log: unit quaternion -> so(3) rotation vector. (..., 4) -> (..., 3).
    Returns the minimal-angle representative (|axis*angle| <= pi)."""
    q = q * _sign_w(q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=_EPS * _EPS))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return k * v


def delta_q(dtheta: torch.Tensor) -> torch.Tensor:
    """First-order quaternion increment [1, θ/2] (the reference IMU factor's
    bias correction, ``bs_common::DeltaQ``)."""
    half = 0.5 * dtheta
    one = torch.ones_like(half[..., :1])
    return quat_normalize(torch.cat([one, half], dim=-1))
