"""SO(3)/SE(3) Lie-group math on torch tensors.

Port of :mod:`beam_slam_tpu.core.lie` (the subset of ``beam_utils/se3.h`` /
``beam_utils/math.h`` that beam_slam uses). The reference dispatches between
numpy and jnp; this module takes torch tensors only.

Conventions:
  * Quaternions are stored ``[w, x, y, z]`` (Hamilton, active rotation).
  * Every function is shape-polymorphic over leading batch dims, has no
    data-dependent control flow, and is safe under ``torch.func.vmap`` /
    ``jacfwd``. Small-angle branches are ``where`` selections on safe
    operands, kept exactly as the reference writes them: the autodiff
    Jacobians are taken at δ = 0, which lies inside those branches.
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


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w,x,y,z]. Branch-free Shepperd:
    the numerically best of the four candidates is picked with a gather.
    (..., 3, 3) -> (..., 4)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q_k^2 values (all >= 0 up to fp error).
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS * _EPS))

    sw = _safe_sqrt(qw2)
    qa = torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01],
                     dim=-1) / (2.0 * sw[..., None])
    sx = _safe_sqrt(qx2)
    qb = torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20],
                     dim=-1) / (2.0 * sx[..., None])
    sy = _safe_sqrt(qy2)
    qc = torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21],
                     dim=-1) / (2.0 * sy[..., None])
    sz = _safe_sqrt(qz2)
    qd = torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz],
                     dim=-1) / (2.0 * sz[..., None])

    vals = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(vals, dim=-1)
    cand = torch.stack([qa, qb, qc, qd], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return q * _sign_w(q)


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


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp_matrix(w: torch.Tensor) -> torch.Tensor:
    """exp: so(3) -> rotation matrix (Rodrigues). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = skew(w)
    WW = W @ W
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * WW


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r of SO(3). (..., 3) -> (..., 3, 3).

      J_r(w) = I - b(θ)·[w]× + c(θ)·[w]×²,
      b = (1-cosθ)/θ², c = (θ - sinθ)/θ³.
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = skew(w)
    WW = W @ W
    return _eye3_like(W) - b[..., None, None] * W + c[..., None, None] * WW


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l(w) = J_r(-w)."""
    return so3_right_jacobian(-w)


def delta_q(dtheta: torch.Tensor) -> torch.Tensor:
    """First-order quaternion increment [1, θ/2] (the reference IMU factor's
    bias correction, ``bs_common::DeltaQ``)."""
    half = 0.5 * dtheta
    one = torch.ones_like(half[..., :1])
    return quat_normalize(torch.cat([one, half], dim=-1))


# ----------------------------------------------------------------------------
# SE(3) helpers (4x4 homogeneous transforms)
# ----------------------------------------------------------------------------


def _bottom_row(like: torch.Tensor, batch) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype,
                       device=like.device)
    return row.expand(tuple(batch) + (1, 4))


def make_transform(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(quat, translation) -> 4x4 transform."""
    R = quat_to_matrix(q)
    top = torch.cat([R, p[..., :, None]], dim=-1)       # (..., 3, 4)
    return torch.cat([top, _bottom_row(q, R.shape[:-2])], dim=-2)


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)
    return torch.cat([top, _bottom_row(T, T.shape[:-2])], dim=-2)


def transform_point(T: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    return (T[..., :3, :3] @ pt[..., None])[..., 0] + T[..., :3, 3]


def transform_to_quat_trans(T: torch.Tensor):
    return matrix_to_quat(T[..., :3, :3]), T[..., :3, 3]


def se3_boxminus_quat(q_a, p_a, q_b, p_b):
    """Minimal 6-dof difference of pose a w.r.t. pose b:
    [log(q_b⁻¹ q_a), p_a - p_b]."""
    dq = quat_mul(quat_conj(q_b), q_a)
    return torch.cat([so3_log(dq), p_a - p_b], dim=-1)
