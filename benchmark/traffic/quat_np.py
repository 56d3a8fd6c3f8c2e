"""Float64 numpy quaternion helpers for the traffic generators
(``[w, x, y, z]``, Hamilton, active rotation; every function broadcasts
over leading axes)."""

from __future__ import annotations

import numpy as np


def mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def conj(q):
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rotate(q, v):
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def to_matrix(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def exp(w):
    """so(3) rotation vector → unit quaternion."""
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    small = theta < 1e-8
    k = np.where(small, 0.5 - theta ** 2 / 48.0,
                 np.sin(0.5 * theta) / np.where(small, 1.0, theta))
    return np.concatenate([np.cos(0.5 * theta), k * w], axis=-1)


def skew(v):
    x, y, z = np.moveaxis(v, -1, 0)
    o = np.zeros_like(x)
    return np.stack([np.stack([o, -z, y], -1), np.stack([z, o, -x], -1),
                     np.stack([-y, x, o], -1)], -2)


def right_jacobian(w):
    """J_r(w) = I − (1 − cos θ)/θ²·[w]× + (θ − sin θ)/θ³·[w]×²."""
    t2 = np.sum(w * w, axis=-1)
    t = np.sqrt(t2)
    small = t2 < 1e-8
    safe = np.where(small, 1.0, t)
    b = np.where(small, 0.5 - t2 / 24.0, (1.0 - np.cos(t)) / safe ** 2)
    c = np.where(small, 1.0 / 6.0 - t2 / 120.0, (t - np.sin(t)) / safe ** 3)
    W = skew(w)
    return (np.eye(3) - b[..., None, None] * W
            + c[..., None, None] * (W @ W))
