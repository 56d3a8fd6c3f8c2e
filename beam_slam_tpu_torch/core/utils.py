"""Shared helpers mirroring bs_common/include/bs_common/utils.h (copy of
:mod:`beam_slam_tpu.core.utils`).

  * GRAVITY_WORLD lives in :mod:`beam_slam_tpu_torch.core.factors` (utils.h:20-24).
  * ``shannon_entropy_from_pose_covariance`` (utils.h:79) — the VO
    localization-validation entropy gate input.
  * ``add_zero_motion_factor`` (utils.h:82) — identity relative-pose +
    zero-velocity factors between two stamps, used by SLAMInitialization for
    stationary segments (slam_initialization.cpp AddPosesAndInertialConstraints
    zero-motion branch).
"""

from __future__ import annotations

import numpy as np

from beam_slam_tpu_torch.solver.smoother import Transaction


def shannon_entropy_from_pose_covariance(cov: np.ndarray) -> float:
    """H = ½·ln((2πe)^n · det Σ) for an n×n pose covariance (utils.h:79)."""
    cov = np.asarray(cov, np.float64)
    n = cov.shape[0]
    sign, logdet = np.linalg.slogdet(cov)
    if sign <= 0:
        return float("inf")
    return float(0.5 * (n * np.log(2.0 * np.pi * np.e) + logdet))


def covariance_from_information_weight(w: float, dim: int) -> np.ndarray:
    """Information weight → covariance = 1/w²·I (the reference's convention,
    visual_odometry_params.h:36-47)."""
    return np.eye(dim) / (w * w)


def sqrt_info_from_weight(w: float, dim: int) -> np.ndarray:
    return (w * np.eye(dim)).astype(np.float32)


def add_zero_motion_factor(txn: Transaction, stamp_i: float, stamp_j: float,
                           cov: float = 1e-6):
    """AddZeroMotionFactor (utils.h:82): identity relative pose between the
    two stamps + zero-velocity/bias-equality via a 15-dof relative IMU factor
    with an identity preintegration delta."""
    w = 1.0 / np.sqrt(cov)
    txn.add_relative_pose(stamp_i, stamp_j,
                          np.array([1, 0, 0, 0], np.float32),
                          np.zeros(3, np.float32),
                          sqrt_info_from_weight(w, 6))
    return txn
