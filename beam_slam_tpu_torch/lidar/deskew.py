"""Per-point scan deskewing (motion compensation); port of
:mod:`beam_slam_tpu.lidar.deskew`.

Replacement for the reference's LidarScanDeskewer plugin
(bs_models/src/lidar_scan_deskewer.cpp:13-62): every point is re-expressed in
the scan-start frame using the pose interpolated at its own timestamp (the
reference queries a FrameInitializer per point; here the whole grid is
compensated in one vectorized pass given the scan-start and scan-end poses
from inertial odometry). The deskewer model (``models/
lidar_scan_deskewer.py``) drives it; :func:`slerp` also serves the frame
initializer."""

from __future__ import annotations

import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.lidar.cloud import RingGrid


def slerp(q0: torch.Tensor, q1: torch.Tensor, s: torch.Tensor
          ) -> torch.Tensor:
    """Quaternion slerp, batched over s (s broadcastable to [...]).
    q0, q1: [4]; s: [...] → [..., 4]. Shortest arc, Taylor-safe."""
    dot = torch.sum(q0 * q1)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    one = torch.ones_like(sin_theta)
    w0 = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta)
                     / torch.where(small, one, sin_theta))
    w1 = torch.where(small, s, torch.sin(s * theta)
                     / torch.where(small, one, sin_theta))
    q = w0[..., None] * q0 + w1[..., None] * q1
    return lie.quat_normalize(q)


def deskew(grid: RingGrid, q0, p0, q1, p1, t0: float, t1: float) -> RingGrid:
    """Motion-compensate ``grid`` into the scan-start frame.

    (q0,p0) / (q1,p1): world-from-lidar poses (tensors on the grid's device)
    at times t0 (scan start) and t1 (scan end); grid.time holds per-point
    offsets from scan start. Result: points as they would appear if all
    were captured at t0.
    """
    s = torch.clamp(grid.time / max(t1 - t0, 1e-6), 0.0, 1.0)
    q_t = slerp(q0, q1, s)                         # [R, W, 4]
    p_t = p0 + s[..., None] * (p1 - p0)            # [R, W, 3]
    # world point, then back into the scan-start frame
    pw = lie.quat_rotate(q_t, grid.xyz) + p_t
    q0_inv = lie.quat_conj(q0)
    xyz0 = lie.quat_rotate(q0_inv[None, None], pw - p0[None, None])
    xyz0 = torch.where(grid.valid[..., None], xyz0, torch.zeros_like(xyz0))
    return grid.replace(xyz=xyz0)
