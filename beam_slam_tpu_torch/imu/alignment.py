"""Visual/lidar-inertial alignment for SLAM initialization (port of
:mod:`beam_slam_tpu.imu.alignment`).

Re-implements bs_models/src/lib/imu/inertial_alignment.cpp: given an
up-to-scale trajectory (from lidar path init or SfM) and the raw IMU stream,
estimate gyro bias (small LSQ over relative rotations, :138-161), then
gravity, monocular scale and per-keyframe velocities (linear system, :163-202),
with the optional 2-dof tangential-basis gravity refinement (:204-247). The
observability gate (:114-136) rejects under-excited motion.

The segments are preintegrated on ``device`` (the card unless asked
otherwise); the small linear systems are solved on the host in float64, and
the rotation algebra runs on host float32 as the reference's does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.core.factors import GRAVITY_NOMINAL
from beam_slam_tpu_torch.device import resolve, to_numpy
from beam_slam_tpu_torch.imu import preintegration as pre


class AlignmentResult(NamedTuple):
    success: bool
    gravity: np.ndarray        # [3] in the path's world frame
    bg: np.ndarray             # [3]
    ba: np.ndarray             # [3]
    scale: float
    velocities: np.ndarray     # [N, 3]
    observability: float


def _f32(x):
    return np.asarray(x, np.float32)


def _segment_deltas(stamps, imu_t, imu_w, imu_a, bg, noise, device):
    """Preintegrate the IMU stream between consecutive path stamps with the
    given gyro bias on ``device`` (host loop — init-time only); the deltas
    come back as host arrays, one wait per segment."""
    noise = pre.PreintNoise(*(torch.as_tensor(c, device=device)
                              for c in noise))
    deltas = []
    for j in range(1, len(stamps)):
        sel = (imu_t >= stamps[j - 1]) & (imu_t < stamps[j])
        t_seg = imu_t[sel]
        if len(t_seg) < 2:
            return None
        # integrate to the next stamp: dt between samples + tail to stamp j
        dts = np.diff(np.concatenate([t_seg, [stamps[j]]])).astype(np.float32)
        t = lambda x: torch.as_tensor(_f32(x), device=device)  # noqa: E731
        d = pre.preintegrate(t(dts), t(imu_w[sel]), t(imu_a[sel]), t(bg),
                             t(np.zeros(3)), noise, compute_information=False)
        deltas.append(pre.Delta(*to_numpy(*(getattr(d, f) for f in (
            "t", "q", "p", "v", "cov", "sqrt_inv_cov", "dq_dbg", "dp_dbg",
            "dp_dba", "dv_dbg", "dv_dba")))))
    return deltas


def imu_observability(deltas) -> float:
    """Std-dev of per-segment mean specific force (inertial_alignment.cpp:
    114-136); < 0.25 means not enough excitation. Note: the reference divides
    the mean by N−1 (:124), which inflates the variance by ‖g‖/(N−1) even for
    perfectly stationary data; we use the proper mean so the gate actually
    fires on zero-excitation streams."""
    g_tmp = np.stack([np.asarray(d.v) / max(float(d.t), 1e-6)
                      for d in deltas])
    aver = g_tmp.mean(axis=0)
    var = np.sum(np.linalg.norm(g_tmp - aver, axis=1) ** 2)
    return float(np.sqrt(var / max(len(deltas) - 1, 1)))


def estimate_gyro_bias(q_path: np.ndarray, deltas) -> np.ndarray:
    """LSQ gyro bias from relative-rotation mismatch (:138-161):
    bg = argmin Σ ‖dq_dbg·bg − log((q_i·Δq_j)⁻¹·q_j)‖²."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for j in range(1, len(q_path)):
        d = deltas[j - 1]
        dq_dbg = np.asarray(d.dq_dbg, np.float64)
        q_pred = lie_np.quat_mul(_f32(q_path[j - 1]), _f32(d.q))
        err = lie_np.so3_log(lie_np.quat_mul(lie_np.quat_conj(q_pred),
                                             _f32(q_path[j])))
        A += dq_dbg.T @ dq_dbg
        b += dq_dbg.T @ np.asarray(err, np.float64)
    return np.linalg.lstsq(A, b, rcond=None)[0]


def estimate_gravity_scale_velocities(q_path, p_path, deltas,
                                      estimate_scale: bool = True):
    """Linear gravity/scale/velocity system (:163-202). Unknowns:
    [g(3), s(1 — only for up-to-scale visual paths), v_0..v_{N-1}(3N)].

    For metric paths (lidar / frame-init), the scale column must be REMOVED
    and the known displacement moved to the RHS — solving for scale on a
    short metric path lets gravity and scale trade off (observed: scale
    collapsing to ≈ −1 and tilting gravity by several degrees).
    """
    N = len(q_path)
    ns = 1 if estimate_scale else 0
    A = np.zeros(((N - 1) * 6, 3 + ns + 3 * N))
    b = np.zeros((N - 1) * 6)
    for j in range(1, N):
        i = j - 1
        d = deltas[i]
        dt = float(d.t)
        Ri = np.asarray(lie_np.quat_to_matrix(_f32(q_path[i])), np.float64)
        dp_path = np.asarray(p_path[j] - p_path[i], np.float64)
        A[i * 6: i * 6 + 3, 0:3] = -0.5 * dt * dt * np.eye(3)
        if estimate_scale:
            A[i * 6: i * 6 + 3, 3] = dp_path
            b[i * 6: i * 6 + 3] = Ri @ np.asarray(d.p, np.float64)
        else:
            b[i * 6: i * 6 + 3] = (Ri @ np.asarray(d.p, np.float64)
                                   - dp_path)
        A[i * 6: i * 6 + 3, 3 + ns + i * 3: 6 + ns + i * 3] = \
            -dt * np.eye(3)
        A[i * 6 + 3: i * 6 + 6, 0:3] = -dt * np.eye(3)
        A[i * 6 + 3: i * 6 + 6, 3 + ns + i * 3: 6 + ns + i * 3] = -np.eye(3)
        A[i * 6 + 3: i * 6 + 6, 3 + ns + j * 3: 6 + ns + j * 3] = np.eye(3)
        b[i * 6 + 3: i * 6 + 6] = Ri @ np.asarray(d.v, np.float64)
    x = np.linalg.lstsq(A, b, rcond=None)[0]
    g_dir = x[0:3] / max(np.linalg.norm(x[0:3]), 1e-9)
    gravity = g_dir * GRAVITY_NOMINAL
    scale = float(x[3]) if estimate_scale else 1.0
    velocities = x[3 + ns:].reshape(N, 3)
    return gravity, scale, velocities


def tangential_basis(g: np.ndarray) -> np.ndarray:
    """3×2 basis of the tangent plane at unit gravity (beam::S2TangentialBasis)."""
    g = g / max(np.linalg.norm(g), 1e-9)
    other = np.array([1.0, 0, 0]) if abs(g[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(g, other)
    b1 /= max(np.linalg.norm(b1), 1e-9)
    b2 = np.cross(g, b1)
    return np.stack([b1, b2], axis=1)


def refine_gravity_scale_velocities(q_path, p_path, deltas, gravity,
                                    damp: float = 0.1, iters: int = 1):
    """2-dof gravity refinement on the S² tangent plane (:204-247), keeping
    ‖g‖ = GRAVITY_NOMINAL."""
    N = len(q_path)
    scale = 1.0
    velocities = np.zeros((N, 3))
    for _ in range(iters):
        Tg = tangential_basis(gravity)
        A = np.zeros(((N - 1) * 6, 3 + 3 * N))
        b = np.zeros((N - 1) * 6)
        for j in range(1, N):
            i = j - 1
            d = deltas[i]
            dt = float(d.t)
            Ri = np.asarray(lie_np.quat_to_matrix(_f32(q_path[i])),
                            np.float64)
            A[i * 6: i * 6 + 3, 0:2] = -0.5 * dt * dt * Tg
            A[i * 6: i * 6 + 3, 2] = p_path[j] - p_path[i]
            A[i * 6: i * 6 + 3, 3 + i * 3: 6 + i * 3] = -dt * np.eye(3)
            b[i * 6: i * 6 + 3] = (0.5 * dt * dt * gravity
                                   + Ri @ np.asarray(d.p, np.float64))
            A[i * 6 + 3: i * 6 + 6, 0:2] = -dt * Tg
            A[i * 6 + 3: i * 6 + 6, 3 + i * 3: 6 + i * 3] = -np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 3 + j * 3: 6 + j * 3] = np.eye(3)
            b[i * 6 + 3: i * 6 + 6] = (dt * gravity
                                       + Ri @ np.asarray(d.v, np.float64))
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        dg = x[0:2]
        gravity = gravity + damp * Tg @ dg
        gravity = gravity / max(np.linalg.norm(gravity), 1e-9) * GRAVITY_NOMINAL
        scale = float(x[2])
        velocities = x[3:].reshape(N, 3)
    return gravity, scale, velocities


def estimate_parameters(path_stamps: np.ndarray, q_path: np.ndarray,
                        p_path: np.ndarray, imu_t: np.ndarray,
                        imu_w: np.ndarray, imu_a: np.ndarray,
                        noise: pre.PreintNoise,
                        min_observability: float = 0.25,
                        refine: bool = False,
                        estimate_scale: bool = False, device=None
                        ) -> Optional[AlignmentResult]:
    """Full EstimateParameters flow (inertial_alignment.cpp:4-112).
    ``estimate_scale=True`` only for up-to-scale (monocular SfM) paths. The
    preintegration runs on ``device``, the card unless asked otherwise."""
    device = resolve(device)
    bg = np.zeros(3)
    ba = np.zeros(3)
    deltas = _segment_deltas(path_stamps, imu_t, imu_w, imu_a, bg, noise,
                             device)
    if deltas is None:
        return None
    obs = imu_observability(deltas)
    if obs < min_observability:
        return AlignmentResult(False, np.zeros(3), bg, ba, 1.0,
                               np.zeros((len(q_path), 3)), obs)

    bg = estimate_gyro_bias(q_path, deltas)
    deltas = _segment_deltas(path_stamps, imu_t, imu_w, imu_a, bg, noise,
                             device)
    gravity, scale, velocities = estimate_gravity_scale_velocities(
        q_path, p_path, deltas, estimate_scale=estimate_scale)
    if refine:
        gravity, scale, velocities = refine_gravity_scale_velocities(
            q_path, p_path, deltas, gravity)
    return AlignmentResult(True, gravity, bg, ba, scale, velocities, obs)


def align_world_to_gravity(gravity: np.ndarray):
    """Rotation q_align such that q_align · gravity ∥ [0,0,-g] — used by
    SLAMInitialization::AlignPathAndVelocities (slam_initialization.cpp:
    400-431) to rotate the init path into the gravity-aligned world frame."""
    g = gravity / max(np.linalg.norm(gravity), 1e-9)
    target = np.array([0.0, 0.0, -1.0])
    v = np.cross(g, target)
    c = float(np.dot(g, target))
    if np.linalg.norm(v) < 1e-9:
        if c > 0:
            return np.array([1.0, 0, 0, 0], np.float32)
        return np.array([0.0, 1.0, 0, 0], np.float32)  # 180° about x
    axis = v / np.linalg.norm(v)
    angle = np.arccos(np.clip(c, -1, 1))
    return lie_np.so3_exp_quat(_f32(axis * angle))
