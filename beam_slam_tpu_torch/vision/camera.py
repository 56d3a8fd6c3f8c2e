"""Pinhole camera model with radial-tangential distortion (port of
:mod:`beam_slam_tpu.vision.camera`).

Replacement for the used subset of libbeam's
``beam_calibration::CameraModel`` (reference call sites:
bs_models/src/visual_odometry.cpp:426-430 — ``UndistortPixel``,
``BackProject``, ``ProjectPoint``). All ops are batched over leading dims
and run on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeRadtan(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    @property
    def intr4(self) -> torch.Tensor:
        """[fx, fy, cx, cy] as a float32 host tensor."""
        return torch.tensor([self.fx, self.fy, self.cx, self.cy],
                            dtype=torch.float32)

    def _distort_normalized(self, xn):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = (x * radial + 2 * self.p1 * x * y
              + self.p2 * (r2 + 2 * x * x))
        yd = (y * radial + self.p1 * (r2 + 2 * y * y)
              + 2 * self.p2 * x * y)
        return torch.stack([xd, yd], dim=-1)

    def project(self, X_cam: torch.Tensor):
        """Camera-frame 3D point(s) → distorted pixel(s). Returns (uv, valid)
        where valid = point in front of the camera and inside the image."""
        z = X_cam[..., 2]
        z_safe = torch.clamp(z, min=1e-6)
        xn = X_cam[..., :2] / z_safe[..., None]
        xd = self._distort_normalized(xn)
        uv = torch.stack([self.fx * xd[..., 0] + self.cx,
                          self.fy * xd[..., 1] + self.cy], dim=-1)
        valid = ((z > 1e-3) & (uv[..., 0] >= 0) & (uv[..., 0] < self.width)
                 & (uv[..., 1] >= 0) & (uv[..., 1] < self.height))
        return uv, valid

    def undistort_pixel(self, uv: torch.Tensor, iters: int = 5):
        """Distorted pixel → undistorted pixel (ideal pinhole). Fixed-point
        iteration on normalized coordinates (beam_calibration UndistortPixel
        equivalent; a fixed iteration count)."""
        xn_d = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy], dim=-1)
        xn = xn_d
        for _ in range(iters):
            delta = self._distort_normalized(xn) - xn
            xn = xn_d - delta
        return torch.stack([self.fx * xn[..., 0] + self.cx,
                            self.fy * xn[..., 1] + self.cy], dim=-1)

    def back_project(self, uv: torch.Tensor, undistorted: bool = True):
        """Pixel → unit bearing ray in the camera frame (``BackProject``)."""
        if not undistorted:
            uv = self.undistort_pixel(uv)
        xn = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy,
                          torch.ones_like(uv[..., 0])], dim=-1)
        return xn / torch.linalg.vector_norm(xn, dim=-1, keepdim=True)
