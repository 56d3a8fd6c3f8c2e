"""IMU preintegration (port of :mod:`beam_slam_tpu.imu.preintegration`).

Midpoint integration of (Δq, Δp, Δv), 15×15 covariance propagation in
error-state order (q, p, v, bg, ba), first-order bias Jacobians, and the
sqrt-inverse-covariance whitener with degeneracy floors and an invalid-cov
fallback weight (bs_common/src/bs_common/preintegrator.cpp:26-144). The
(q,p,v) block never couples into the bias blocks, so the 9×9 block is
propagated and the two 3×3 bias blocks accumulated separately.

The sample loop is a Python loop over the buffer with every step written
over leading batch dims (one batch entry per segment), so B segments of N
samples cost N batched steps.

The host-numpy mirrors (:func:`preintegrate_np`, :func:`sqrt_inv_cov_np`,
:func:`predict_state_np`) are the online factor-creation path, as in the
reference: a keyframe interval holds ~20-100 samples, microseconds of host
math, where a device pass would cost a launch per sample and a wait.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import scipy.linalg as sla
import torch

from beam_slam_tpu_torch.core import lie, lie_np
from beam_slam_tpu_torch.core.factors import GRAVITY_NOMINAL
from beam_slam_tpu_torch.core.window import Struct


class PreintNoise(NamedTuple):
    """Continuous-time noise model; each entry is a 3×3 covariance."""

    cov_w: torch.Tensor
    cov_a: torch.Tensor
    cov_bg: torch.Tensor
    cov_ba: torch.Tensor

    @staticmethod
    def isotropic(sig_w: float, sig_a: float, sig_bg: float, sig_ba: float,
                  dtype=torch.float32, device=None) -> "PreintNoise":
        eye = torch.eye(3, dtype=dtype, device=device)
        return PreintNoise(cov_w=sig_w ** 2 * eye, cov_a=sig_a ** 2 * eye,
                           cov_bg=sig_bg ** 2 * eye, cov_ba=sig_ba ** 2 * eye)


@dataclasses.dataclass
class Delta(Struct):
    """Preintegrated increment plus the bias Jacobians; every field carries
    the segments' leading batch dims."""

    t: torch.Tensor             # [...] total integration time
    q: torch.Tensor             # [..., 4]
    p: torch.Tensor             # [..., 3]
    v: torch.Tensor             # [..., 3]
    cov: torch.Tensor           # [..., 15, 15]
    sqrt_inv_cov: torch.Tensor  # [..., 15, 15]
    dq_dbg: torch.Tensor        # [..., 3, 3]
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor


# Degeneracy floors (preintegrator.h:130-134) and invalid-cov fallback (:141).
COV_TOL = 1e-5
BIAS_COV_TOL = 1e-9
INVALID_INV_COV_WEIGHT = 1e-4


def preintegrate(dt: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                 bg: torch.Tensor, ba: torch.Tensor, noise: PreintNoise,
                 valid: Optional[torch.Tensor] = None,
                 compute_information: bool = True) -> Delta:
    """Integrate buffers of IMU samples (PreIntegrator::Integrate).

    dt: [..., N] per-sample interval; samples with dt <= 0 or
    ``valid == False`` are skipped. w, a: [..., N, 3]. bg, ba: bias
    linearization points, broadcastable to [..., 3]. Without
    ``compute_information`` the whitener is left zero (the odometry and
    alignment paths read only the delta)."""
    dtype, dev = w.dtype, w.device
    lead = dt.shape[:-1]
    valid = (dt > 0) if valid is None else (valid & (dt > 0))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z = lambda *s: torch.zeros(lead + s, dtype=dtype, device=dev)  # noqa: E731
    bg = bg.to(dtype).expand(lead + (3,))
    ba = ba.to(dtype).expand(lead + (3,))

    q = lie.quat_identity(lead, dtype, dev)
    p, v = z(3), z(3)
    cov9, cov_bg, cov_ba = z(9, 9), z(3, 3), z(3, 3)
    dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba = (z(3, 3) for _ in range(5))
    t = z()

    for n in range(dt.shape[-1]):
        h = dt[..., n]
        hv, hm = h[..., None], h[..., None, None]
        wi = w[..., n, :] - bg
        ai = a[..., n, :] - ba
        q_full = lie.so3_exp_quat(wi * hv)
        q_half = lie.so3_exp_quat(0.5 * wi * hv)

        R_delta = lie.quat_to_matrix(q)                      # R(Δq) before
        R_full_T = lie.quat_to_matrix(q_full).transpose(-1, -2)
        skew_a = lie.skew(ai)
        Jr = lie.so3_right_jacobian(wi * hv)
        R_skew = R_delta @ skew_a

        # covariance propagation (9×9 q,p,v block; preintegrator.cpp:38-66)
        A = torch.eye(9, dtype=dtype, device=dev).repeat(lead + (1, 1))
        A[..., 0:3, 0:3] = R_full_T
        A[..., 6:9, 0:3] = -hm * R_skew
        A[..., 3:6, 0:3] = -0.5 * hm * hm * R_skew
        A[..., 3:6, 6:9] = hm * eye3
        B = z(9, 6)
        B[..., 0:3, 0:3] = hm * Jr
        B[..., 6:9, 3:6] = hm * R_delta
        B[..., 3:6, 3:6] = 0.5 * hm * hm * R_delta
        inv_h = 1.0 / torch.clamp(hm, min=1e-7)
        Qw = z(6, 6)
        Qw[..., 0:3, 0:3] = noise.cov_w * inv_h
        Qw[..., 3:6, 3:6] = noise.cov_a * inv_h

        cov9_new = A @ cov9 @ A.transpose(-1, -2) \
            + B @ Qw @ B.transpose(-1, -2)
        cov_bg_new = cov_bg + noise.cov_bg * hm
        cov_ba_new = cov_ba + noise.cov_ba * hm

        # bias jacobians (preintegrator.cpp:69-80; update order matters)
        dp_dbg_new = dp_dbg + hm * dv_dbg - 0.5 * hm * hm * R_skew @ dq_dbg
        dp_dba_new = dp_dba + hm * dv_dba - 0.5 * hm * hm * R_delta
        dv_dbg_new = dv_dbg - hm * R_skew @ dq_dbg
        dv_dba_new = dv_dba - hm * R_delta
        dq_dbg_new = R_full_T @ dq_dbg - hm * Jr

        # midpoint state update (preintegrator.cpp:82-88)
        a_mid = lie.quat_rotate(lie.quat_mul(q, q_half), ai)
        p_new = p + hv * v + 0.5 * hv * hv * a_mid
        v_new = v + hv * a_mid
        q_new = lie.quat_normalize(lie.quat_mul(q, q_full))

        ok = valid[..., n]
        okv, okm = ok[..., None], ok[..., None, None]
        q = torch.where(okv, q_new, q)
        p = torch.where(okv, p_new, p)
        v = torch.where(okv, v_new, v)
        cov9 = torch.where(okm, cov9_new, cov9)
        cov_bg = torch.where(okm, cov_bg_new, cov_bg)
        cov_ba = torch.where(okm, cov_ba_new, cov_ba)
        dq_dbg = torch.where(okm, dq_dbg_new, dq_dbg)
        dp_dbg = torch.where(okm, dp_dbg_new, dp_dbg)
        dp_dba = torch.where(okm, dp_dba_new, dp_dba)
        dv_dbg = torch.where(okm, dv_dbg_new, dv_dbg)
        dv_dba = torch.where(okm, dv_dba_new, dv_dba)
        t = torch.where(ok, t + h, t)

    cov = z(15, 15)
    cov[..., 0:9, 0:9] = cov9
    cov[..., 9:12, 9:12] = cov_bg
    cov[..., 12:15, 12:15] = cov_ba
    sqrt_inv = sqrt_inv_cov(cov) if compute_information else z(15, 15)
    return Delta(t=t, q=q, p=p, v=v, cov=cov, sqrt_inv_cov=sqrt_inv,
                 dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba,
                 dv_dbg=dv_dbg, dv_dba=dv_dba)


def sqrt_inv_cov(cov: torch.Tensor) -> torch.Tensor:
    """Whitening matrix A with AᵀA = cov⁻¹ (PreIntegrator::ComputeSqrtInvCov)
    for cov [..., 15, 15], with the reference's degeneracy floors.

    Jacobi-equilibrate cov, Cholesky, triangular-solve the identity; falls
    back to INVALID_INV_COV_WEIGHT · I when the factorization fails."""
    dtype, dev = cov.dtype, cov.device
    eye15 = torch.eye(15, dtype=dtype, device=dev)

    # Degeneracy floors (reference :121-133).
    def floor(c, lo, hi, tol):
        repl = c.clone()
        repl[..., lo:hi, lo:hi] = tol * torch.eye(hi - lo, dtype=dtype,
                                                  device=dev)
        n = torch.linalg.matrix_norm(c[..., lo:hi, lo:hi])
        return torch.where((n < tol)[..., None, None], repl, c)

    cov = floor(cov, 0, 9, COV_TOL)
    cov = floor(cov, 9, 15, BIAS_COV_TOL)

    d = torch.diagonal(cov, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(d, min=1e-30))
    cov_s = cov * (s[..., :, None] * s[..., None, :])
    C, info = torch.linalg.cholesky_ex(cov_s)
    Cinv = torch.linalg.solve_triangular(C, eye15.expand_as(C), upper=False)
    # cov⁻¹ = S·cov_s⁻¹·S = (Cinv·S)ᵀ(Cinv·S)  →  A = Cinv·diag(s).
    A = Cinv * s[..., None, :]
    ok = torch.isfinite(A).flatten(-2).all(dim=-1) & (info == 0)
    return torch.where(ok[..., None, None], A, INVALID_INV_COV_WEIGHT * eye15)


def predict_state(delta: Delta, q_i, p_i, v_i, gravity=None):
    """Propagate state i through a preintegrated delta
    (ImuPreintegration::PredictState, imu_preintegration.cpp:220-244):
      q_j = q_i ⊗ Δq;  p_j = p_i + v_i·Δt + ½g·Δt² + R(q_i)·Δp;
      v_j = v_i + g·Δt + R(q_i)·Δv."""
    if gravity is None:
        gravity = torch.zeros_like(v_i)
        gravity[..., 2] = -GRAVITY_NOMINAL
    dt = delta.t[..., None]
    q_j = lie.quat_normalize(lie.quat_mul(q_i, delta.q))
    p_j = (p_i + dt * v_i + 0.5 * dt * dt * gravity
           + lie.quat_rotate(q_i, delta.p))
    v_j = v_i + dt * gravity + lie.quat_rotate(q_i, delta.v)
    return q_j, p_j, v_j


# ---------------------------------------------------------------------------
# Host-numpy mirror — the online factor-creation path
# ---------------------------------------------------------------------------

def preintegrate_np(dt, w, a, bg, ba, noise: PreintNoise,
                    compute_information: bool = True) -> Delta:
    """Float64 numpy mirror of :func:`preintegrate` for one segment; the
    fields of the returned :class:`Delta` are float32 numpy arrays."""
    dt = np.asarray(dt, np.float64)
    w = np.asarray(w, np.float64)
    a = np.asarray(a, np.float64)
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    cov_w, cov_a, cov_bg_n, cov_ba_n = (
        np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c, np.float64)
        for c in noise)

    q = np.array([1.0, 0, 0, 0])
    p = np.zeros(3)
    v = np.zeros(3)
    cov9 = np.zeros((9, 9))
    cov_bg = np.zeros((3, 3))
    cov_ba = np.zeros((3, 3))
    dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba = (np.zeros((3, 3))
                                              for _ in range(5))
    t = 0.0
    eye3 = np.eye(3)

    for i in range(len(dt)):
        h = float(dt[i])
        if h <= 0:
            continue
        wi = w[i] - bg
        ai = a[i] - ba
        q_full = lie_np.so3_exp_quat(wi * h)
        q_half = lie_np.so3_exp_quat(0.5 * wi * h)
        R_delta = lie_np.quat_to_matrix(q)
        R_full_T = lie_np.quat_to_matrix(q_full).T
        skew_a = lie_np.skew(ai)
        Jr = lie_np.so3_right_jacobian(wi * h)

        A = np.eye(9)
        A[0:3, 0:3] = R_full_T
        A[6:9, 0:3] = -h * R_delta @ skew_a
        A[3:6, 0:3] = -0.5 * h * h * R_delta @ skew_a
        A[3:6, 6:9] = h * eye3
        B = np.zeros((9, 6))
        B[0:3, 0:3] = h * Jr
        B[6:9, 3:6] = h * R_delta
        B[3:6, 3:6] = 0.5 * h * h * R_delta
        Qw = np.zeros((6, 6))
        inv_h = 1.0 / max(h, 1e-7)
        Qw[0:3, 0:3] = cov_w * inv_h
        Qw[3:6, 3:6] = cov_a * inv_h
        cov9 = A @ cov9 @ A.T + B @ Qw @ B.T
        cov_bg = cov_bg + cov_bg_n * h
        cov_ba = cov_ba + cov_ba_n * h

        dp_dbg = dp_dbg + h * dv_dbg - 0.5 * h * h * R_delta @ skew_a @ dq_dbg
        dp_dba = dp_dba + h * dv_dba - 0.5 * h * h * R_delta
        dv_dbg = dv_dbg - h * R_delta @ skew_a @ dq_dbg
        dv_dba = dv_dba - h * R_delta
        dq_dbg = R_full_T @ dq_dbg - h * Jr

        a_mid = lie_np.quat_rotate(lie_np.quat_mul(q, q_half), ai)
        p = p + h * v + 0.5 * h * h * a_mid
        v = v + h * a_mid
        q = lie_np.quat_normalize(lie_np.quat_mul(q, q_full))
        t += h

    cov = np.zeros((15, 15))
    cov[0:9, 0:9] = cov9
    cov[9:12, 9:12] = cov_bg
    cov[12:15, 12:15] = cov_ba
    sqrt_inv = (sqrt_inv_cov_np(cov) if compute_information
                else np.zeros((15, 15), np.float32))
    f32 = np.float32
    return Delta(t=f32(t), q=q.astype(f32), p=p.astype(f32),
                 v=v.astype(f32), cov=cov.astype(f32),
                 sqrt_inv_cov=sqrt_inv.astype(f32),
                 dq_dbg=dq_dbg.astype(f32), dp_dbg=dp_dbg.astype(f32),
                 dp_dba=dp_dba.astype(f32), dv_dbg=dv_dbg.astype(f32),
                 dv_dba=dv_dba.astype(f32))


def sqrt_inv_cov_np(cov) -> np.ndarray:
    """numpy mirror of :func:`sqrt_inv_cov` (same floors and fallback)."""
    cov = np.asarray(cov, np.float64).copy()
    if np.linalg.norm(cov[0:9, 0:9]) < COV_TOL:
        cov[0:9, 0:9] = COV_TOL * np.eye(9)
    if np.linalg.norm(cov[9:15, 9:15]) < BIAS_COV_TOL:
        cov[9:15, 9:15] = BIAS_COV_TOL * np.eye(6)
    s = 1.0 / np.sqrt(np.maximum(np.diagonal(cov), 1e-30))
    cov_s = cov * (s[:, None] * s[None, :])
    try:
        C = np.linalg.cholesky(cov_s)
    except np.linalg.LinAlgError:
        return (INVALID_INV_COV_WEIGHT * np.eye(15)).astype(np.float32)
    A = sla.solve_triangular(C, np.eye(15), lower=True) * s[None, :]
    if not np.isfinite(A).all():
        return (INVALID_INV_COV_WEIGHT * np.eye(15)).astype(np.float32)
    return A.astype(np.float32)


def predict_state_np(delta: Delta, q_i, p_i, v_i):
    """numpy mirror of :func:`predict_state` (float64 inside, float32 out)."""
    g = np.asarray([0.0, 0.0, -GRAVITY_NOMINAL])
    q_i = np.asarray(q_i, np.float64)
    p_i = np.asarray(p_i, np.float64)
    v_i = np.asarray(v_i, np.float64)
    dt = float(delta.t)
    q_j = lie_np.quat_normalize(
        lie_np.quat_mul(q_i, np.asarray(delta.q, np.float64)))
    p_j = (p_i + dt * v_i + 0.5 * dt * dt * g
           + lie_np.quat_rotate(q_i, np.asarray(delta.p, np.float64)))
    v_j = v_i + dt * g + lie_np.quat_rotate(q_i,
                                            np.asarray(delta.v, np.float64))
    return (q_j.astype(np.float32), p_j.astype(np.float32),
            v_j.astype(np.float32))
