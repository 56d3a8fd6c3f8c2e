"""Trajectory evaluation: alignment + ATE RMSE (a numpy copy of
:mod:`beam_slam_tpu.utils.evaluation`).

The reference publishes no accuracy numbers (BASELINE.md); ATE against
ground truth is self-generated. Standard practice: rigidly align the
estimated trajectory to GT (Umeyama / yaw-only for gravity-aligned frames)
before computing RMSE, since SLAM world frames are anchored arbitrarily
(first scan pose, gravity-aligned yaw)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray,
                  with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray,
                                                     float]:
    """Least-squares rigid (optionally similarity) alignment:
    gt ≈ s·R·est + t. Returns (R, t, s)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    C = xg.T @ xe / len(est)
    U, S, Vt = np.linalg.svd(C)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(S) @ D) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def align_yaw_only(est: np.ndarray, gt: np.ndarray):
    """4-dof (yaw + translation) alignment for gravity-aligned frames."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = (est - mu_e)[:, :2]
    xg = (gt - mu_g)[:, :2]
    num = np.sum(xe[:, 0] * xg[:, 1] - xe[:, 1] * xg[:, 0])
    den = np.sum(xe[:, 0] * xg[:, 0] + xe[:, 1] * xg[:, 1])
    yaw = np.arctan2(num, den)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t = mu_g - R @ mu_e
    return R, t, 1.0


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "se3") -> float:
    """Absolute trajectory error RMSE after alignment.
    align: 'se3' | 'sim3' | 'yaw' | 'none'."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align == "se3":
        R, t, s = align_umeyama(est, gt, with_scale=False)
    elif align == "sim3":
        R, t, s = align_umeyama(est, gt, with_scale=True)
    elif align == "yaw":
        R, t, s = align_yaw_only(est, gt)
    else:
        R, t, s = np.eye(3), np.zeros(3), 1.0
    est_aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est_aligned - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
