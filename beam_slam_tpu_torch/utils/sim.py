"""Analytic ground-truth trajectory simulator (port of
:mod:`beam_slam_tpu.utils.sim`): a smooth SE(3) trajectory whose exact IMU
measurements come from forward-mode autodiff (``torch.func.jvp``), as the
reference takes them from ``jax.jacfwd``, and a regularly sampled IMU stream
over it (:func:`imu_measurements`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jvp

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.autodiff import FORWARD_AD
from beam_slam_tpu_torch.core.factors import GRAVITY_NOMINAL
from beam_slam_tpu_torch.device import resolve


class TrajectorySample(NamedTuple):
    t: torch.Tensor       # [N]
    q: torch.Tensor       # [N, 4] world-from-body
    p: torch.Tensor       # [N, 3]
    v: torch.Tensor       # [N, 3]
    w_body: torch.Tensor  # [N, 3] exact gyro (body frame)
    a_body: torch.Tensor  # [N, 3] exact accelerometer (body frame, incl. gravity)


class AnalyticTrajectory:
    """Sinusoidal C-infinity SE(3) trajectory.

    p(t) = amp_p ⊙ [sin(ω₀t), cos(ω₁t), sin(ω₂t)] + v_drift·t
    θ(t) = amp_r ⊙ [sin(ν₀t), sin(ν₁t), sin(ν₂t)]   (rotation vector)
    q(t) = exp(θ(t))

    Its tensors live on ``device``, the card unless asked otherwise.
    """

    def __init__(self, amp_p=(1.0, 1.0, 0.4), freq_p=(0.9, 0.7, 1.1),
                 v_drift=(0.25, 0.0, 0.05), amp_r=(0.4, 0.3, 0.5),
                 freq_r=(0.8, 1.2, 0.6), dtype=torch.float32, device=None):
        device = resolve(device)
        as_t = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
        self.amp_p = as_t(amp_p)
        self.freq_p = as_t(freq_p)
        self.v_drift = as_t(v_drift)
        self.amp_r = as_t(amp_r)
        self.freq_r = as_t(freq_r)
        self.dtype = dtype
        self.device = device

    # Trajectory functions of a time tensor t [...] -> [..., 3] / [..., 4].
    def p(self, t):
        ph = self.freq_p * t[..., None]
        osc = torch.stack([torch.sin(ph[..., 0]), torch.cos(ph[..., 1]),
                           torch.sin(ph[..., 2])], dim=-1)
        return self.amp_p * osc + self.v_drift * t[..., None]

    def theta(self, t):
        return self.amp_r * torch.sin(self.freq_r * t[..., None])

    def q(self, t):
        return lie.so3_exp_quat(self.theta(t))

    def sample(self, t: torch.Tensor) -> TrajectorySample:
        """Sample states + exact IMU measurements at times t [...]."""
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        one = torch.ones_like(t)

        def vel(tt):
            return jvp(self.p, (tt,), (one,))[1]

        with FORWARD_AD:   # one forward-AD user at a time (core/autodiff)
            p, v = jvp(self.p, (t,), (one,))
            acc_w = jvp(vel, (t,), (one,))[1]
            q, qdot = jvp(self.q, (t,), (one,))
        # body angular velocity: w = 2 · vec(q⁻¹ ⊗ q̇)
        w_body = 2.0 * lie.quat_mul(lie.quat_conj(q), qdot)[..., 1:4]
        # accelerometer measures R(q)ᵀ · (a_world - g)
        g_world = torch.zeros_like(acc_w)
        g_world[..., 2] = -GRAVITY_NOMINAL
        a_body = lie.quat_rotate(lie.quat_conj(q), acc_w - g_world)
        return TrajectorySample(t=t, q=q, p=p, v=v, w_body=w_body,
                                a_body=a_body)


def imu_measurements(traj: AnalyticTrajectory, t0: float, t1: float,
                     rate_hz: float, generator: Optional[torch.Generator] = None,
                     sig_w: float = 0.0, sig_a: float = 0.0,
                     device=None) -> TrajectorySample:
    """Regularly-sampled IMU stream over [t0, t1] with optional white noise,
    on ``device`` (the card unless asked otherwise). The noise is drawn on
    the host from ``generator`` (a seeded ``torch.Generator``), so a run is
    reproducible; without one the stream is exact."""
    device = resolve(device)
    n = int(round((t1 - t0) * rate_hz)) + 1
    t = t0 + torch.arange(n, dtype=traj.dtype, device=traj.device) / rate_hz
    s = TrajectorySample(*(x.to(device) for x in traj.sample(t)))
    if generator is not None and (sig_w > 0 or sig_a > 0):
        def noise(x, sig):
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype)
            return x + sig * z.to(device)
        s = s._replace(w_body=noise(s.w_body, sig_w),
                       a_body=noise(s.a_body, sig_a))
    return s
