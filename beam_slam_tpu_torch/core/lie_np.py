"""SO(3) math on host numpy arrays: the numpy half of the reference's
backend-dual :mod:`beam_slam_tpu.core.lie`, copied.

The host pipeline (transaction building, odometry bookkeeping, seeds, the
preintegration mirrors) calls these on tiny arrays many times per scan;
they run eagerly on the host in the input's dtype and never touch a device.
:mod:`beam_slam_tpu_torch.core.lie` is the tensor half.

Quaternions are ``[w, x, y, z]`` (Hamilton, active rotation); every function
is shape-polymorphic over leading dims.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def skew(v) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    v = np.asarray(v)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    return np.stack([np.stack([zero, -z, y], axis=-1),
                     np.stack([z, zero, -x], axis=-1),
                     np.stack([-y, x, zero], axis=-1)], axis=-2)


def quat_mul(a, b) -> np.ndarray:
    """Hamilton product a ⊗ b."""
    a = np.asarray(a)
    b = np.asarray(b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def quat_conj(q) -> np.ndarray:
    q = np.asarray(q)
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q) -> np.ndarray:
    q = np.asarray(q)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, _EPS)


def quat_rotate(q, v) -> np.ndarray:
    """R(q) @ v by the 15-mul expansion."""
    q = np.asarray(q)
    v = np.asarray(v)
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def quat_to_matrix(q) -> np.ndarray:
    q = np.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.stack([
        np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ], axis=-2)


def matrix_to_quat(R) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w,x,y,z], (..., 3, 3) -> (..., 4):
    the branch-free Shepperd of the reference (the numerically best of the
    four candidates), sign canonicalized to w >= 0."""
    R = np.asarray(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return np.sqrt(np.maximum(x, _EPS * _EPS))

    sw = _safe_sqrt(qw2)
    qa = np.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01],
                  axis=-1) / (2.0 * sw[..., None])
    sx = _safe_sqrt(qx2)
    qb = np.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20],
                  axis=-1) / (2.0 * sx[..., None])
    sy = _safe_sqrt(qy2)
    qc = np.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21],
                  axis=-1) / (2.0 * sy[..., None])
    sz = _safe_sqrt(qz2)
    qd = np.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz],
                  axis=-1) / (2.0 * sz[..., None])
    best = np.argmax(np.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)
    cand = np.stack([qa, qb, qc, qd], axis=-2)  # (..., 4 candidates, 4)
    q = np.take_along_axis(cand, best[..., None, None], axis=-2)[..., 0, :]
    q = quat_normalize(q)
    return q * np.where(q[..., 0:1] < 0, -1.0, 1.0).astype(q.dtype)


def so3_exp_quat(w) -> np.ndarray:
    """so(3) -> unit quaternion, Taylor-safe near zero."""
    w = np.asarray(w)
    theta2 = np.sum(w * w, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    k = np.where(small, 0.5 - theta2 / 48.0, np.sin(0.5 * theta) / theta)
    cw = np.where(small, 1.0 - theta2 / 8.0, np.cos(0.5 * theta))
    return np.concatenate([cw, k * w], axis=-1)


def so3_log(q) -> np.ndarray:
    """Unit quaternion -> minimal rotation vector."""
    q = np.asarray(q)
    q = q * np.where(q[..., 0:1] < 0, -1.0, 1.0).astype(q.dtype)
    w = np.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn2 = np.sum(v * v, axis=-1, keepdims=True)
    vn = np.sqrt(np.maximum(vn2, _EPS * _EPS))
    angle = 2.0 * np.arctan2(vn, w)
    small = vn2 < _EPS
    k = np.where(small, 2.0 / np.maximum(w, _EPS), angle / vn)
    return k * v


def so3_right_jacobian(w) -> np.ndarray:
    """J_r(w) = I − b(θ)·[w]× + c(θ)·[w]×²."""
    w = np.asarray(w)
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(np.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    with np.errstate(divide="ignore", invalid="ignore"):  # small: unused
        b = np.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta)) / theta2)
        c = np.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - np.sin(theta)) / (theta2 * theta))
    W = skew(w)
    eye = np.broadcast_to(np.eye(3, dtype=w.dtype), W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * (W @ W)
