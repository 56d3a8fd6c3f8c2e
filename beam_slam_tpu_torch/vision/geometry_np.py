"""Host-numpy multi-view geometry for the per-frame visual-odometry path
(a copy of :mod:`beam_slam_tpu.vision.geometry_np`).

The online visual-odometry path runs one PnP refine per camera frame
(20 Hz) and a handful of triangulations and gates per keyframe, each on
at most a few hundred points: microseconds of numpy on the host, where a
device dispatch and the reads of its gates would cost more than the math.
The reference likewise runs this on the CPU (beam_cv Triangulation /
PoseRefinement's Ceres PnP, visual_odometry.cpp:217,532).

The tensor versions in :mod:`beam_slam_tpu_torch.vision.geometry` are the
batch path (SfM initialization); tests/test_torch_vision.py holds both
against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from beam_slam_tpu_torch.core import lie_np as lie


def _quat_to_R(q):
    return np.asarray(lie.quat_to_matrix(np.asarray(q, np.float64)))


def triangulate_dlt_np(q_wc1, p_wc1, q_wc2, p_wc2, ray1, ray2):
    """Two-view midpoint triangulation (numpy mirror of
    geometry.triangulate_dlt, single point)."""
    d1 = np.asarray(lie.quat_rotate(np.asarray(q_wc1, np.float64),
                                    np.asarray(ray1, np.float64)))
    d2 = np.asarray(lie.quat_rotate(np.asarray(q_wc2, np.float64),
                                    np.asarray(ray2, np.float64)))
    p1 = np.asarray(p_wc1, np.float64)
    p2 = np.asarray(p_wc2, np.float64)
    b = p2 - p1
    d11 = d1 @ d1
    d22 = d2 @ d2
    d12 = d1 @ d2
    denom = d11 * d22 - d12 * d12
    bd1 = b @ d1
    bd2 = b @ d2
    denom_safe = denom if abs(denom) >= 1e-9 else 1e-9
    t1 = (bd1 * d22 - bd2 * d12) / denom_safe
    t2 = (bd1 * d12 - bd2 * d11) / denom_safe
    X = 0.5 * ((p1 + t1 * d1) + (p2 + t2 * d2))
    valid = (t1 > 1e-3) and (t2 > 1e-3) and (abs(denom) > 1e-6)
    return X.astype(np.float32), bool(valid)


def reproj_gate_np(q_wc, p_wc, intr4, X_w, uv, max_px) -> bool:
    """numpy mirror of geometry.triangulation_reprojection_gate."""
    q = np.asarray(q_wc, np.float64)
    X_c = np.asarray(lie.quat_rotate(
        np.asarray(lie.quat_conj(q)),
        np.asarray(X_w, np.float64) - np.asarray(p_wc, np.float64)))
    z = max(float(X_c[2]), 1e-6)
    intr4 = np.asarray(intr4, np.float64)
    u = intr4[0] * X_c[0] / z + intr4[2]
    v = intr4[1] * X_c[1] / z + intr4[3]
    err = float(np.hypot(u - float(uv[0]), v - float(uv[1])))
    return (err < float(max_px)) and (float(X_c[2]) > 1e-3)


class PnPResultNp(NamedTuple):
    q: np.ndarray
    p: np.ndarray
    information: np.ndarray
    mean_error_px: float
    n_inliers: int
    converged: bool


def refine_pose_np(q0, p0, X_w, uv, intr4, valid, iterations: int = 10,
                   huber_px: float = 3.0,
                   min_inliers: int = 10) -> PnPResultNp:
    """GN PnP refine, numpy mirror of geometry.refine_pose with ANALYTIC
    Jacobians (the closed-form reprojection chain): residual order and
    Huber weighting match the jitted version; tangent is [dθ(right), dp].
    """
    q = np.asarray(q0, np.float64).copy()
    p = np.asarray(p0, np.float64).copy()
    X = np.asarray(X_w, np.float64)
    uvn = np.asarray(uv, np.float64)
    fx, fy, cx, cy = [float(x) for x in np.asarray(intr4)]
    vmask = np.asarray(valid, bool)
    H = np.eye(6)
    ok_all = True

    for _ in range(iterations):
        R = _quat_to_R(q)
        X_c = (X - p) @ R                       # = Rᵀ(X-p) rowwise
        z = np.maximum(X_c[:, 2], 1e-3)
        u = fx * X_c[:, 0] / z + cx
        v = fy * X_c[:, 1] / z + cy
        r = np.stack([u - uvn[:, 0], v - uvn[:, 1]], axis=1)   # [N, 2]
        en = np.linalg.norm(r, axis=1)
        w = np.where(en <= huber_px, 1.0, huber_px / np.maximum(en, 1e-9))
        w = w * vmask

        # analytic Jacobian: ∂r/∂X_c then chain to [skew(X_c) | -Rᵀ]
        inv_z = 1.0 / z
        A = np.zeros((len(X), 2, 3))
        A[:, 0, 0] = fx * inv_z
        A[:, 0, 2] = -fx * X_c[:, 0] * inv_z * inv_z
        A[:, 1, 1] = fy * inv_z
        A[:, 1, 2] = -fy * X_c[:, 1] * inv_z * inv_z
        sk = np.zeros((len(X), 3, 3))
        sk[:, 0, 1] = -X_c[:, 2]
        sk[:, 0, 2] = X_c[:, 1]
        sk[:, 1, 0] = X_c[:, 2]
        sk[:, 1, 2] = -X_c[:, 0]
        sk[:, 2, 0] = -X_c[:, 1]
        sk[:, 2, 1] = X_c[:, 0]
        J = np.concatenate([np.einsum("nij,njk->nik", A, sk),
                            -np.einsum("nij,jk->nik", A, R.T)],
                           axis=2)              # [N, 2, 6]
        Jw = J * w[:, None, None]
        Jf = J.reshape(-1, 6)
        rw = (r * w[:, None]).reshape(-1)
        H = Jf.T @ Jw.reshape(-1, 6) + 1e-6 * np.eye(6)
        g = -Jf.T @ rw
        try:
            delta = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            ok_all = False
            break
        if not np.all(np.isfinite(delta)):
            ok_all = False
            break
        q = np.asarray(lie.quat_normalize(lie.quat_mul(
            q, np.asarray(lie.so3_exp_quat(delta[0:3])))))
        p = p + delta[3:6]

    R = _quat_to_R(q)
    X_c = (X - p) @ R
    z = np.maximum(X_c[:, 2], 1e-3)
    u = fx * X_c[:, 0] / z + cx
    v = fy * X_c[:, 1] / z + cy
    en = np.hypot(u - uvn[:, 0], v - uvn[:, 1])
    inl = vmask & (en < 2 * huber_px)
    n_inl = int(inl.sum())
    mean_err = float((en * inl).sum() / max(n_inl, 1))
    return PnPResultNp(q=q.astype(np.float32), p=p.astype(np.float32),
                       information=H, mean_error_px=mean_err,
                       n_inliers=n_inl,
                       converged=ok_all and n_inl >= min_inliers)
