"""Synthetic sliding-window problem builder (port of
:mod:`beam_slam_tpu.utils.synthetic`): the flagship LVIO window.

K IMU states connected by preintegrated IMU factors, lidar-odometry-like
relative-pose factors with a sensor extrinsic, a window-start prior and,
with ``with_vision``, the visual BA families (Euclidean reprojection and
binary inverse-depth factors), with the reference's census and parameters.

Randomness comes from a ``torch.Generator`` in place of ``jax.random``, so
the draws (initial-state perturbations, landmark placement, pixel noise)
differ from the reference's; everything else — slots, preintegrated deltas,
relative-pose measurements, extrinsics, intrinsics — is the same
deterministic function of the census. Draws are taken on the host from a CPU
generator and moved to ``device``, so one seed gives one window on every
device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from beam_slam_tpu_torch.core import factors as fc
from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core import window as win
from beam_slam_tpu_torch.core.window import WindowState
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.imu import preintegration as pre
from beam_slam_tpu_torch.utils import sim

# Camera model of the synthetic vision problem (pinhole).
_INTR = (500.0, 500.0, 320.0, 240.0)
_PIX_SIGMA = 1.0


class _Draws:
    """Host-side draws from a CPU generator, moved to the build device."""

    def __init__(self, gen: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = gen, dtype, device

    def normal(self, *shape):
        return torch.randn(shape, generator=self.gen,
                           dtype=self.dtype).to(self.device)

    def uniform(self, n, lo, hi):
        u = torch.rand((n,), generator=self.gen, dtype=self.dtype)
        return (u * (hi - lo) + lo).to(self.device)


def build_lvio_window(gen: torch.Generator, n_kf: int = 32,
                      kf_dt: float = 0.25, rate_hz: float = 200.0,
                      perturb: float = 0.05,
                      with_rel_pose: bool = True, with_vision: bool = False,
                      n_landmarks: int = 256, obs_per_lm: int = 8,
                      n_idp: int = 0, dtype=torch.float32,
                      device=None) -> Tuple[WindowState, Tuple, Tuple]:
    """Returns (window, families, losses) for one synthetic LVIO window.

    ``gen`` is a CPU ``torch.Generator``; the window is built on ``device``
    (the card unless asked otherwise).
    With ``with_vision`` the window carries ``n_landmarks`` Euclidean
    landmarks each observed from ``obs_per_lm`` consecutive keyframes
    (→ n_landmarks·obs_per_lm ReprojectionFactors) plus ``n_idp``
    inverse-depth landmarks with binary anchor→measurement factors."""
    device = resolve(device)
    K = n_kf  # state capacity: one slot per keyframe
    rnd = _Draws(gen, dtype, device)
    traj = sim.AnalyticTrajectory(dtype=dtype, device=device)
    kf_t = torch.arange(n_kf, dtype=dtype, device=device) * kf_dt
    gt = traj.sample(kf_t)

    # ---- perturbed initial states (state 0 pinned by the prior)
    dth = perturb * rnd.normal(n_kf, 3)
    dp = perturb * rnd.normal(n_kf, 3)
    dv = perturb * rnd.normal(n_kf, 3)
    keep0 = (torch.arange(n_kf, device=device) > 0)[:, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    q0 = lie.quat_mul(gt.q, lie.so3_exp_quat(torch.where(keep0, dth, zero)))
    p0 = gt.p + torch.where(keep0, dp, zero)
    v0 = gt.v + torch.where(keep0, dv, zero)

    L_cap = (n_landmarks + n_idp) if with_vision else 0
    window = WindowState.zeros(K, E=3, L=L_cap, dtype=dtype, device=device)
    imu = window.imu
    imu.q[:n_kf] = q0
    imu.p[:n_kf] = p0
    imu.v[:n_kf] = v0
    imu.active[:n_kf] = True

    # ---- preintegrated IMU chain (segments batched, midpoint sampling)
    n_samp = int(round(kf_dt * rate_hz))
    dt = kf_dt / n_samp
    S = n_kf - 1
    t_mid = kf_t[:-1, None] + (torch.arange(n_samp, dtype=dtype,
                                            device=device)[None, :] + 0.5) * dt
    meas = traj.sample(t_mid)                     # leaves [S, n_samp, ...]
    noise = pre.PreintNoise.isotropic(1e-4, 1e-3, 1e-6, 1e-5, dtype, device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)
    deltas = pre.preintegrate(
        torch.full((S, n_samp), dt, dtype=dtype, device=device),
        meas.w_body, meas.a_body, zero3, zero3, noise)

    idx = torch.arange(S, device=device)
    rel = fc.ImuRelativeFactors.zeros(K, dtype, device)
    rel.slots[:S] = torch.stack([idx, idx + 1], dim=1)
    rel.active[:S] = True
    for name in ("dq_dbg", "dp_dbg", "dp_dba", "dv_dbg", "dv_dba"):
        getattr(rel, name)[:S] = getattr(deltas, name)
    rel.dt[:S] = deltas.t
    rel.dq[:S] = deltas.q
    rel.dp[:S] = deltas.p
    rel.dv[:S] = deltas.v
    rel.sqrt_info[:S] = deltas.sqrt_inv_cov

    prior = fc.ImuPriorFactors.zeros(2, dtype, device)
    prior.active[0] = True
    prior.q0[0] = gt.q[0]
    prior.p0[0] = gt.p[0]
    prior.v0[0] = gt.v[0]
    prior.sqrt_info[0] = 1e3 * torch.eye(15, dtype=dtype, device=device)

    families = [rel, prior]
    losses = [None, None]

    if with_rel_pose:
        # lidar-odometry-like relative pose factors in a sensor frame
        q_e = lie.so3_exp_quat(torch.tensor([0.1, -0.2, 0.3], dtype=dtype,
                                            device=device))
        p_e = torch.tensor([0.2, 0.1, -0.3], dtype=dtype, device=device)
        ext = window.extrinsics
        ext.q[1], ext.p[1] = q_e, p_e
        ext.active[1] = True
        ext.held[1] = True
        q_ws = lie.quat_mul(gt.q, q_e[None, :])
        p_ws = gt.p + lie.quat_rotate(gt.q, p_e[None, :])
        q_ws_inv = lie.quat_conj(q_ws[:-1])
        rp = fc.RelativePoseFactors.zeros(K, dtype, device)
        rp.slots[:S] = torch.stack([idx, idx + 1, torch.ones_like(idx)], dim=1)
        rp.active[:S] = True
        rp.dq[:S] = lie.quat_mul(q_ws_inv, q_ws[1:])
        rp.dp[:S] = lie.quat_rotate(q_ws_inv, p_ws[1:] - p_ws[:-1])
        rp.sqrt_info[:S] = 1e2 * torch.eye(6, dtype=dtype, device=device)
        families.append(rp)
        losses.append(1.0)  # Cauchy, as the reference attaches to lidar factors

    if with_vision:
        window, vis_families, vis_losses = _add_vision(
            rnd, window, gt, n_kf, n_landmarks, obs_per_lm, n_idp, perturb)
        families.extend(vis_families)
        losses.extend(vis_losses)

    return window, tuple(families), tuple(losses)


def _add_vision(rnd: _Draws, window: WindowState, gt, n_kf: int, n_lm: int,
                obs_per_lm: int, n_idp: int, perturb: float):
    """Visual-BA factor families over the GT trajectory. The camera
    extrinsic lives in Poses slot 2 (held). Each landmark is parked in front
    of the camera of the midpoint keyframe of its observation run, so all
    its observations have positive depth."""
    dtype, device = rnd.dtype, rnd.device
    fx, fy, cx, cy = _INTR
    intr = torch.tensor(_INTR, dtype=dtype, device=device)
    eye2 = torch.eye(2, dtype=dtype, device=device) / _PIX_SIGMA

    q_bc = lie.so3_exp_quat(torch.tensor([0.02, -0.01, 0.03], dtype=dtype,
                                         device=device))
    p_bc = torch.tensor([0.1, 0.0, 0.05], dtype=dtype, device=device)
    ext = window.extrinsics
    ext.q[2], ext.p[2] = q_bc, p_bc
    ext.active[2] = True
    ext.held[2] = True

    # GT camera poses per keyframe
    q_wc = lie.quat_mul(gt.q, q_bc[None, :])
    p_wc = gt.p + lie.quat_rotate(gt.q, p_bc[None, :])
    span = max(n_kf - obs_per_lm, 1)

    def make_landmarks(n, anchor0):
        """anchor keyframes + world positions for n landmarks."""
        a = torch.arange(n, device=device) * span // max(n - 1, 1)
        mid = torch.clamp(a + obs_per_lm // 2, 0, n_kf - 1)
        xn = rnd.uniform(n, -0.45, 0.45)
        yn = rnd.uniform(n, -0.35, 0.35)
        z = rnd.uniform(n, 4.0, 12.0)
        X_c = torch.stack([xn * z, yn * z, z], dim=1)
        ref = a if anchor0 else mid
        return a, lie.quat_rotate(q_wc[ref], X_c) + p_wc[ref]

    def project(X_w, kf):
        """pixel of world points X_w [n, 1, 3] in keyframes kf [n, O]."""
        X_c = lie.quat_rotate(lie.quat_conj(q_wc[kf]), X_w - p_wc[kf])
        z = torch.clamp(X_c[..., 2], min=1e-3)
        return torch.stack([fx * X_c[..., 0] / z + cx,
                            fy * X_c[..., 1] / z + cy], dim=-1)

    families, losses = [], []

    # ---- Euclidean landmarks → ReprojectionFactors
    a_lm, X_w = make_landmarks(n_lm, anchor0=False)
    obs_kf = a_lm[:, None] + torch.arange(obs_per_lm, device=device)[None, :]
    pix = project(X_w[:, None, :], obs_kf)
    pix = pix + _PIX_SIGMA * rnd.normal(*pix.shape)

    F = n_lm * obs_per_lm
    lm_slot = torch.repeat_interleave(torch.arange(n_lm, device=device),
                                      obs_per_lm)
    reproj = fc.ReprojectionFactors.zeros(F, dtype, device)
    reproj.slots[:] = torch.stack(
        [obs_kf.reshape(-1), torch.full_like(lm_slot, 2), lm_slot], dim=1)
    reproj.active[:] = True
    reproj.pixel[:] = pix.reshape(F, 2)
    reproj.intr[:] = intr
    reproj.sqrt_info[:] = eye2
    families.append(reproj)
    losses.append(2.0)  # Cauchy on visual factors, as the reference VO

    # perturbed initial landmark estimates (GT + noise)
    lm = window.landmarks
    lm.pt[:n_lm] = X_w + 2.0 * perturb * rnd.normal(*X_w.shape)
    lm.active[:n_lm] = True

    # ---- inverse-depth landmarks → binary anchor/measurement factors
    if n_idp > 0:
        a_idp, X_idp = make_landmarks(n_idp, anchor0=True)
        # bearing in the anchor camera: (mx, my) of X/z
        X_ca = lie.quat_rotate(lie.quat_conj(q_wc[a_idp]), X_idp - p_wc[a_idp])
        rho_gt = 1.0 / torch.clamp(X_ca[:, 2], min=1e-3)
        bearing = X_ca[:, :2] * rho_gt[:, None]
        O = obs_per_lm - 1  # measurements exclude the anchor frame
        meas_kf = a_idp[:, None] + 1 + torch.arange(O, device=device)[None, :]
        pix_i = project(X_idp[:, None, :], meas_kf)
        pix_i = pix_i + _PIX_SIGMA * rnd.normal(*pix_i.shape)
        Fi = n_idp * O
        idp_slot = n_lm + torch.repeat_interleave(
            torch.arange(n_idp, device=device), O)
        idp = fc.InverseDepthReprojectionFactors.zeros(Fi, dtype, device)
        idp.slots[:] = torch.stack(
            [torch.repeat_interleave(a_idp, O), meas_kf.reshape(-1),
             torch.full_like(idp_slot, 2), idp_slot], dim=1)
        idp.active[:] = True
        idp.bearing[:] = torch.repeat_interleave(bearing, O, dim=0)
        idp.pixel[:] = pix_i.reshape(Fi, 2)
        idp.intr[:] = intr
        idp.sqrt_info[:] = eye2
        families.append(idp)
        losses.append(2.0)
        # initial ρ perturbed ~10%
        rho0 = rho_gt * (1.0 + 0.1 * rnd.normal(n_idp))
        lm.pt[n_lm:n_lm + n_idp, 0] = rho0
        lm.active[n_lm:n_lm + n_idp] = True

    return window, families, losses


def build_lvio_batch(gen: torch.Generator, batch: int, **kw):
    """Batch of independent windows of one census (leading axis = submap):
    the same slots and measurements model in every window, fresh draws from
    ``gen`` for each. Losses are shared. Built on ``device`` (the card
    unless asked otherwise)."""
    kw["device"] = resolve(kw.get("device"))
    built = [build_lvio_window(gen, **kw) for _ in range(batch)]
    windows = win.stack([b[0] for b in built])
    families = tuple(win.stack([b[1][i] for b in built])
                     for i in range(len(built[0][1])))
    return windows, families, built[0][2]
