"""LVIO-window traffic: B windows of one census, drawn from a seed.

Every window is the same LVIO tick over an analytic trajectory: K IMU
states ``kf_dt`` apart, K − 1 preintegrated IMU factors over a
``rate_hz`` IMU stream, a prior on the first state, K − 1 lidar
relative-pose factors measured through a held lidar extrinsic (Cauchy
``loss_lidar``), ``n_landmarks`` Euclidean landmarks seen from
``obs_per_lm`` consecutive keyframes through a held camera extrinsic and
``n_idp`` inverse-depth landmarks seen from ``obs_per_lm − 1`` keyframes
after their anchor (Cauchy ``loss_vision``). The census, the trajectory,
the extrinsics, the intrinsics and the noise model follow the program's
synthetic LVIO window; this module carries its own copy of that
arithmetic, so the traffic does not move when the program changes.

What differs between windows and seeds is drawn on the device from one
``torch.Generator`` in two calls: the perturbations of the initial states
(σ ``perturb`` on rotation, position and velocity; state 0 exact), the
landmarks' places, the pixel noise, the landmarks' initial errors (σ
2·``perturb``) and the inverse depths' (10%). The trajectory and the
preintegrated IMU deltas are the same in every window, worked out once in
float64 numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import lie
from benchmark.traffic import quat_np as qn

GRAVITY = 9.80665
# The analytic trajectory: p(t) = amp_p ⊙ [sin ω₀t, cos ω₁t, sin ω₂t] +
# v_drift·t, rotation vector θ(t) = amp_r ⊙ sin(ν t).
AMP_P, FREQ_P = np.array([1.0, 1.0, 0.4]), np.array([0.9, 0.7, 1.1])
V_DRIFT = np.array([0.25, 0.0, 0.05])
AMP_R, FREQ_R = np.array([0.4, 0.3, 0.5]), np.array([0.8, 1.2, 0.6])
# IMU noise densities (gyro, accel, gyro bias, accel bias) and floors of
# the covariance's whitening
IMU_SIGMA = (1e-4, 1e-3, 1e-6, 1e-5)
COV_TOL, BIAS_COV_TOL, INVALID_INV_COV_WEIGHT = 1e-5, 1e-9, 1e-4
# extrinsics (rotation vector, translation): the lidar's and the camera's
LIDAR = ((0.1, -0.2, 0.3), (0.2, 0.1, -0.3))
CAMERA = ((0.02, -0.01, 0.03), (0.1, 0.0, 0.05))
INTR = (500.0, 500.0, 320.0, 240.0)
PIX_SIGMA = 1.0
PRIOR_SQRT_INFO, LIDAR_SQRT_INFO = 1e3, 1e2


def trajectory(t):
    """(q, p, v, gyro, accel) of the trajectory at times t [n], float64."""
    t = np.asarray(t, np.float64)[:, None]
    ph = FREQ_P * t
    p = AMP_P * np.stack([np.sin(ph[:, 0]), np.cos(ph[:, 1]),
                          np.sin(ph[:, 2])], -1) + V_DRIFT * t
    v = AMP_P * FREQ_P * np.stack([np.cos(ph[:, 0]), -np.sin(ph[:, 1]),
                                   np.cos(ph[:, 2])], -1) + V_DRIFT
    a = -AMP_P * FREQ_P ** 2 * np.stack([np.sin(ph[:, 0]), np.cos(ph[:, 1]),
                                         np.sin(ph[:, 2])], -1)
    theta = AMP_R * np.sin(FREQ_R * t)
    q = qn.exp(theta)
    gyro = np.einsum("nij,nj->ni", qn.right_jacobian(theta),
                     AMP_R * FREQ_R * np.cos(FREQ_R * t))
    accel = qn.rotate(qn.conj(q), a - np.array([0.0, 0.0, -GRAVITY]))
    return q, p, v, gyro, accel


def _sqrt_inv_cov(cov):
    """A with AᵀA = cov⁻¹, with the degeneracy floors and the fallback."""
    cov = cov.copy()
    if np.linalg.norm(cov[0:9, 0:9]) < COV_TOL:
        cov[0:9, 0:9] = COV_TOL * np.eye(9)
    if np.linalg.norm(cov[9:15, 9:15]) < BIAS_COV_TOL:
        cov[9:15, 9:15] = BIAS_COV_TOL * np.eye(6)
    s = 1.0 / np.sqrt(np.maximum(np.diagonal(cov), 1e-30))
    try:
        C = np.linalg.cholesky(cov * (s[:, None] * s[None, :]))
    except np.linalg.LinAlgError:
        return INVALID_INV_COV_WEIGHT * np.eye(15)
    A = np.linalg.solve(C, np.eye(15)) * s[None, :]
    return A if np.isfinite(A).all() else INVALID_INV_COV_WEIGHT * np.eye(15)


def preintegrate(h: float, gyro, accel):
    """Midpoint preintegration at zero bias of S segments at once (gyro,
    accel [S, n, 3]): (Δt, Δq, Δp, Δv, dq_dbg, dp_dbg, dp_dba, dv_dbg,
    dv_dba, sqrt_info), each with the leading segment axis."""
    sw, sa, sbg, sba = IMU_SIGMA
    S, n = gyro.shape[:2]
    z3 = np.zeros((S, 3, 3))
    q = np.broadcast_to([1.0, 0.0, 0.0, 0.0], (S, 4))
    p, v = np.zeros((S, 3)), np.zeros((S, 3))
    cov9 = np.zeros((S, 9, 9))
    dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba = z3, z3, z3, z3, z3
    eye3 = np.eye(3)
    for k in range(n):
        wi, ai = gyro[:, k], accel[:, k]
        q_full, q_half = qn.exp(wi * h), qn.exp(0.5 * wi * h)
        R = qn.to_matrix(q)
        R_full_T = np.swapaxes(qn.to_matrix(q_full), -1, -2)
        RSa = R @ qn.skew(ai)
        Jr = qn.right_jacobian(wi * h)
        A = np.broadcast_to(np.eye(9), (S, 9, 9)).copy()
        A[:, 0:3, 0:3] = R_full_T
        A[:, 6:9, 0:3] = -h * RSa
        A[:, 3:6, 0:3] = -0.5 * h * h * RSa
        A[:, 3:6, 6:9] = h * eye3
        Bm = np.zeros((S, 9, 6))
        Bm[:, 0:3, 0:3] = h * Jr
        Bm[:, 6:9, 3:6] = h * R
        Bm[:, 3:6, 3:6] = 0.5 * h * h * R
        Qw = np.zeros((6, 6))
        Qw[0:3, 0:3] = sw ** 2 * eye3 / h
        Qw[3:6, 3:6] = sa ** 2 * eye3 / h
        cov9 = (A @ cov9 @ np.swapaxes(A, -1, -2)
                + Bm @ Qw @ np.swapaxes(Bm, -1, -2))
        dp_dbg = dp_dbg + h * dv_dbg - 0.5 * h * h * RSa @ dq_dbg
        dp_dba = dp_dba + h * dv_dba - 0.5 * h * h * R
        dv_dbg = dv_dbg - h * RSa @ dq_dbg
        dv_dba = dv_dba - h * R
        dq_dbg = R_full_T @ dq_dbg - h * Jr
        a_mid = qn.rotate(qn.mul(q, q_half), ai)
        p = p + h * v + 0.5 * h * h * a_mid
        v = v + h * a_mid
        q = qn.normalize(qn.mul(q, q_full))
    cov = np.zeros((S, 15, 15))
    cov[:, 0:9, 0:9] = cov9
    cov[:, 9:12, 9:12] = sbg ** 2 * eye3 * h * n
    cov[:, 12:15, 12:15] = sba ** 2 * eye3 * h * n
    A15 = np.stack([_sqrt_inv_cov(c) for c in cov])
    return (np.full(S, h * n), q, p, v, dq_dbg, dp_dbg, dp_dba, dv_dbg,
            dv_dba, A15)


def census(params: Dict) -> Dict[str, int]:
    K, n_lm = int(params["n_kf"]), int(params["n_landmarks"])
    obs, n_idp = int(params["obs_per_lm"]), int(params["n_idp"])
    return dict(states=K, imu=K - 1, lidar=K - 1, reprojection=n_lm * obs,
                inverse_depth=n_idp * (obs - 1), landmarks=n_lm + n_idp)


def _shared(params: Dict):
    """The draws-free part of a window, float64 numpy."""
    K, kf_dt = int(params["n_kf"]), float(params["kf_dt"])
    n_samp = int(round(kf_dt * float(params["rate_hz"])))
    h = kf_dt / n_samp
    kf_t = np.arange(K) * kf_dt
    q, p, v, _, _ = trajectory(kf_t)
    t = kf_t[:-1, None] + (np.arange(n_samp) + 0.5)[None, :] * h
    _, _, _, gyro, accel = trajectory(t.reshape(-1))
    return (q, p, v), preintegrate(h, gyro.reshape(K - 1, n_samp, 3),
                                   accel.reshape(K - 1, n_samp, 3))


def generate(params: Dict, batch: int, seed: int, device
             ) -> Tuple[Dict, List[Tuple[str, Dict]], Tuple]:
    """``batch`` windows on ``device`` as plain tensors: (window, families,
    losses). ``window`` maps each state block (``imu``, ``extrinsics``,
    ``landmarks``, ``motion``) to its leaves, every leaf with the leading
    batch axis; ``families`` lists (family name, leaves), the factor leaves
    also batched (slots and masks equal across the batch)."""
    B = batch
    K, obs = int(params["n_kf"]), int(params["obs_per_lm"])
    n_lm, n_idp = int(params["n_landmarks"]), int(params["n_idp"])
    perturb = float(params["perturb"])
    S, L, O = K - 1, n_lm + n_idp, obs - 1
    dev = torch.device(device)
    f32 = torch.float32
    (q_gt, p_gt, v_gt), pre = _shared(params)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=dev)  # noqa: E731

    # the draws: one normal and one uniform call for the whole batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n_sizes = [K * 3] * 3 + [n_lm * obs * 2, n_lm * 3, n_idp * O * 2, n_idp]
    u_sizes = [n_lm] * 3 + [n_idp] * 3
    z = torch.randn((B, sum(n_sizes)), generator=gen, device=dev,
                    dtype=f32).split(n_sizes, dim=1)
    u = torch.rand((B, sum(u_sizes)), generator=gen, device=dev,
                   dtype=f32).split(u_sizes, dim=1)
    dth, dpp, dvv = (perturb * x.reshape(B, K, 3) for x in z[:3])
    keep0 = (torch.arange(K, device=dev) > 0)[None, :, None].to(f32)

    qg, pg, vg = T(q_gt), T(p_gt), T(v_gt)
    imu = dict(
        q=lie.quat_mul(qg.expand(B, K, 4), lie.so3_exp_quat(dth * keep0)),
        p=pg + dpp * keep0, v=vg + dvv * keep0,
        bg=torch.zeros(B, K, 3, device=dev), ba=torch.zeros(B, K, 3, device=dev),
        active=torch.ones(K, dtype=torch.bool, device=dev),
        held=torch.zeros(K, dtype=torch.bool, device=dev))
    q_l, p_l = lie.so3_exp_quat(T(LIDAR[0])), T(LIDAR[1])
    q_c, p_c = lie.so3_exp_quat(T(CAMERA[0])), T(CAMERA[1])
    ext = dict(q=torch.stack([lie.quat_identity((), f32, dev), q_l, q_c]),
               p=torch.stack([torch.zeros(3, device=dev), p_l, p_c]),
               active=torch.tensor([False, True, True], device=dev),
               held=torch.tensor([False, True, True], device=dev))

    idx = torch.arange(S, device=dev)
    pad = lambda x, n, fill=0.0: torch.cat(  # noqa: E731
        [x, torch.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype,
                       device=dev)])
    dt_, dq_, dp_, dv_, dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba, A = (
        T(x) for x in pre)
    ident = lie.quat_identity((1,), f32, dev)
    rel = dict(
        slots=pad(torch.stack([idx, idx + 1], 1), K, 0),
        active=pad(torch.ones(S, dtype=torch.bool, device=dev), K, False),
        dt=pad(dt_, K), dq=torch.cat([dq_, ident.expand(K - S, 4)]),
        dp=pad(dp_, K), dv=pad(dv_, K),
        bg_lin=torch.zeros(K, 3, device=dev),
        ba_lin=torch.zeros(K, 3, device=dev),
        dq_dbg=pad(dq_dbg, K), dp_dbg=pad(dp_dbg, K), dp_dba=pad(dp_dba, K),
        dv_dbg=pad(dv_dbg, K), dv_dba=pad(dv_dba, K), sqrt_info=pad(A, K))
    prior = dict(
        slots=torch.zeros(2, 1, dtype=torch.long, device=dev),
        active=torch.tensor([True, False], device=dev),
        q0=torch.cat([qg[:1], ident]), p0=pad(pg[:1], 2), v0=pad(vg[:1], 2),
        bg0=torch.zeros(2, 3, device=dev), ba0=torch.zeros(2, 3, device=dev),
        sqrt_info=pad(PRIOR_SQRT_INFO * torch.eye(15, device=dev)[None], 2))
    q_ws = lie.quat_mul(qg, q_l[None])
    p_ws = pg + lie.quat_rotate(qg, p_l[None])
    q_ws_inv = lie.quat_conj(q_ws[:-1])
    rp = dict(
        slots=pad(torch.stack([idx, idx + 1, torch.ones_like(idx)], 1), K, 0),
        active=pad(torch.ones(S, dtype=torch.bool, device=dev), K, False),
        dq=torch.cat([lie.quat_mul(q_ws_inv, q_ws[1:]),
                      ident.expand(K - S, 4)]),
        dp=pad(lie.quat_rotate(q_ws_inv, p_ws[1:] - p_ws[:-1]), K),
        sqrt_info=pad(LIDAR_SQRT_INFO * torch.eye(6, device=dev)[None]
                      .expand(S, 6, 6), K))

    # ---- vision: landmarks parked in front of a keyframe's camera
    q_wc = lie.quat_mul(qg, q_c[None])
    p_wc = pg + lie.quat_rotate(qg, p_c[None])
    span = max(K - obs, 1)
    intr = T(INTR)

    def place(n, ux, uy, uz, anchor0):
        a = torch.arange(n, device=dev) * span // max(n - 1, 1)
        ref = a if anchor0 else torch.clamp(a + obs // 2, 0, K - 1)
        zz = uz * 8.0 + 4.0
        X_c = torch.stack([(ux * 0.9 - 0.45) * zz, (uy * 0.7 - 0.35) * zz,
                           zz], -1)                       # [B, n, 3]
        return a, lie.quat_rotate(q_wc[ref], X_c) + p_wc[ref]

    def project(X_w, kf):
        X_c = lie.quat_rotate(lie.quat_conj(q_wc[kf]), X_w - p_wc[kf])
        zc = torch.clamp(X_c[..., 2], min=1e-3)
        return torch.stack([INTR[0] * X_c[..., 0] / zc + INTR[2],
                            INTR[1] * X_c[..., 1] / zc + INTR[3]], -1)

    a_lm, X_w = place(n_lm, u[0], u[1], u[2], anchor0=False)
    obs_kf = a_lm[:, None] + torch.arange(obs, device=dev)[None, :]
    pix = project(X_w[:, :, None, :], obs_kf) \
        + PIX_SIGMA * z[3].reshape(B, n_lm, obs, 2)
    F = n_lm * obs
    lm_slot = torch.repeat_interleave(torch.arange(n_lm, device=dev), obs)
    reproj = dict(
        slots=torch.stack([obs_kf.reshape(-1), torch.full_like(lm_slot, 2),
                           lm_slot], 1),
        active=torch.ones(F, dtype=torch.bool, device=dev),
        pixel=pix.reshape(B, F, 2), intr=intr.expand(F, 4),
        sqrt_info=(torch.eye(2, device=dev) / PIX_SIGMA).expand(F, 2, 2))
    pt = torch.zeros(B, L, 3, device=dev)
    pt[:, :n_lm] = X_w + 2.0 * perturb * z[4].reshape(B, n_lm, 3)

    a_idp, X_idp = place(n_idp, u[3], u[4], u[5], anchor0=True)
    X_ca = lie.quat_rotate(lie.quat_conj(q_wc[a_idp]), X_idp - p_wc[a_idp])
    rho_gt = 1.0 / torch.clamp(X_ca[..., 2], min=1e-3)
    bearing = X_ca[..., :2] * rho_gt[..., None]
    meas_kf = a_idp[:, None] + 1 + torch.arange(O, device=dev)[None, :]
    pix_i = project(X_idp[:, :, None, :], meas_kf) \
        + PIX_SIGMA * z[5].reshape(B, n_idp, O, 2)
    Fi = n_idp * O
    idp_slot = n_lm + torch.repeat_interleave(
        torch.arange(n_idp, device=dev), O)
    idp = dict(
        slots=torch.stack([torch.repeat_interleave(a_idp, O),
                           meas_kf.reshape(-1), torch.full_like(idp_slot, 2),
                           idp_slot], 1),
        active=torch.ones(Fi, dtype=torch.bool, device=dev),
        bearing=torch.repeat_interleave(bearing, O, dim=1),
        pixel=pix_i.reshape(B, Fi, 2), intr=intr.expand(Fi, 4),
        sqrt_info=(torch.eye(2, device=dev) / PIX_SIGMA).expand(Fi, 2, 2))
    pt[:, n_lm:, 0] = rho_gt * (1.0 + 0.1 * z[6])
    lms = dict(pt=pt, active=torch.ones(L, dtype=torch.bool, device=dev),
               held=torch.zeros(L, dtype=torch.bool, device=dev))
    motion = dict(w=torch.zeros(1, 3, device=dev),
                  a=torch.zeros(1, 3, device=dev),
                  active=torch.zeros(1, dtype=torch.bool, device=dev),
                  held=torch.zeros(1, dtype=torch.bool, device=dev))

    def batched(leaves, per_window=()):
        """Every leaf with the leading batch axis: those named in
        ``per_window`` have it already, the shared ones are expanded."""
        return {k: (x if k in per_window else x.expand((B,) + x.shape))
                .contiguous() for k, x in leaves.items()}

    window = dict(imu=batched(imu, ("q", "p", "v", "bg", "ba")),
                  extrinsics=batched(ext), landmarks=batched(lms, ("pt",)),
                  motion=batched(motion))
    families = [("ImuRelativeFactors", batched(rel)),
                ("ImuPriorFactors", batched(prior)),
                ("RelativePoseFactors", batched(rp)),
                ("ReprojectionFactors", batched(reproj, ("pixel",))),
                ("InverseDepthReprojectionFactors",
                 batched(idp, ("bearing", "pixel")))]
    losses = (None, None, float(params["loss_lidar"]),
              float(params["loss_vision"]), float(params["loss_vision"]))
    return window, families, losses

