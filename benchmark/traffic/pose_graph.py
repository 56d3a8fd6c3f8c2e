"""Pose-graph traffic: a g2o ``create_sphere`` graph drawn from a seed.

``rings`` rings of ``poses_per_ring`` poses on a sphere of ``radius``
metres, laid out as g2o's ``create_sphere`` lays them (pose k, 1-based
id = k + 1: yaw −π + 2π·n/poses_per_ring, pitch −π/2 + π·id/(rings ·
poses_per_ring), position R·(radius, 0, 0)). Edges: the odometry chain
(k − 1, k) and one edge from each pose to its neighbour in the next ring,
the same yaw one ring on. Each measurement is the true relative
pose times a noise pose: translation + N(0, σ_t²) per axis, rotation by
the normalized quaternion (1 − |ε|, ε), ε ~ N(0, σ_q²) per axis, as
``create_sphere`` draws it. The initial guess composes the noisy odometry
from the true first pose, which is held fixed (g2o fixes the first
vertex). Everything is drawn in float64 numpy from ``seed`` and handed
over as float32 tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.traffic import quat_np as qn


def sphere(rings: int, poses_per_ring: int, radius: float):
    """True poses (q [N, 4], p [N, 3]) of the sphere, float64."""
    k = np.arange(rings * poses_per_ring)
    n = k % poses_per_ring
    yaw = -np.pi + 2.0 * np.pi * n / poses_per_ring
    pitch = -0.5 * np.pi + (k + 1) * np.pi / (rings * poses_per_ring)
    zero = np.zeros_like(yaw)
    qz = np.stack([np.cos(yaw / 2), zero, zero, np.sin(yaw / 2)], -1)
    qy = np.stack([np.cos(pitch / 2), zero, np.sin(pitch / 2), zero], -1)
    q = qn.mul(qz, qy)
    p = qn.rotate(q, np.broadcast_to([radius, 0.0, 0.0], (len(k), 3)))
    return q, p


def edges(rings: int, poses_per_ring: int):
    """(i, j) of the odometry chain, then of the ring-to-ring loops."""
    N = rings * poses_per_ring
    odo = np.stack([np.arange(N - 1), np.arange(1, N)], -1)
    below = np.arange((rings - 1) * poses_per_ring)
    return odo, np.stack([below, below + poses_per_ring], -1)


def generate(params: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The graph as a dict of tensors on ``device`` (the layout
    :mod:`benchmark.reference.pose_graph` documents)."""
    R, P = int(params["rings"]), int(params["poses_per_ring"])
    sig_t, sig_q = float(params["sigma_t"]), float(params["sigma_q"])
    rng = np.random.default_rng(seed)
    q, p = sphere(R, P, float(params["radius"]))
    odo, loop = edges(R, P)
    ij = np.concatenate([odo, loop])
    F = len(ij)
    i, j = ij[:, 0], ij[:, 1]
    qi_inv = qn.conj(q[i])
    dq = qn.mul(qi_inv, q[j])
    dp = qn.rotate(qi_inv, p[j] - p[i])
    eps = sig_q * rng.standard_normal((F, 3))
    w = np.maximum(1.0 - np.linalg.norm(eps, axis=-1, keepdims=True), 0.0)
    dq = qn.normalize(qn.mul(dq, qn.normalize(np.concatenate([w, eps], -1))))
    dp = dp + sig_t * rng.standard_normal((F, 3))

    # initial guess: the noisy odometry composed from the true first pose
    N = R * P
    q0, p0 = np.empty_like(q), np.empty_like(p)
    q0[0], p0[0] = q[0], p[0]
    for k in range(1, N):
        q0[k] = qn.normalize(qn.mul(q0[k - 1], dq[k - 1]))
        p0[k] = p0[k - 1] + qn.rotate(q0[k - 1], dp[k - 1])

    # whitening of the program's residual [rotation vector, translation]:
    # the rotation vector is twice the quaternion's vector part
    sqrt_info = np.diag([1.0 / (2.0 * sig_q)] * 3 + [1.0 / sig_t] * 3)
    free = np.ones(N, bool)
    free[0] = False
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    prob = dict(
        q=f32(q0), p=f32(p0), free=torch.as_tensor(free),
        i=i64(i), j=i64(j), dq=f32(dq), dp=f32(dp),
        sqrt_info=f32(np.broadcast_to(sqrt_info, (F, 6, 6))),
        active=torch.ones(F, dtype=torch.bool),
        # the program takes a block of absolute priors; the first pose is
        # held, so the graph's one prior is inactive
        prior_slot=i64([0]), prior_q0=f32(q[:1]), prior_p0=f32(p[:1]),
        prior_sqrt_info=f32(np.eye(6)[None]),
        prior_active=torch.zeros(1, dtype=torch.bool))
    return {k: v.to(device) for k, v in prob.items()}
