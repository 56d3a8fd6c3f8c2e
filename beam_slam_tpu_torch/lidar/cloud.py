"""Fixed-shape point-cloud containers (port of
:mod:`beam_slam_tpu.lidar.cloud`).

Static-shape tensors + validity masks in place of PCL's point types, and the
host-side "organize" step that bins an unordered scan into the ring-major
grid consumed by the LOAM feature extraction. ``organize_scan`` bins with
the host C++ library (``ops/native.py``) where a ``g++`` is on ``PATH``, and
with :func:`organize_scan_numpy`, its plain version, where none is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core.window import Struct
from beam_slam_tpu_torch.device import resolve, to_device


@dataclasses.dataclass
class RingGrid(Struct):
    """Ring-organized scan: [R, W] grid, azimuth-ordered within each ring.
    ``time`` is the per-point relative timestamp (seconds from scan start)."""

    xyz: torch.Tensor    # [R, W, 3]
    time: torch.Tensor   # [R, W]
    valid: torch.Tensor  # [R, W] bool


@dataclasses.dataclass
class FeatureCloud(Struct):
    """LOAM feature sets with strong/weak split (edges/surfaces ×
    strong/weak)."""

    edge_strong: torch.Tensor   # [E1, 3]
    edge_strong_valid: torch.Tensor
    edge_weak: torch.Tensor     # [E2, 3]
    edge_weak_valid: torch.Tensor
    surf_strong: torch.Tensor   # [S1, 3]
    surf_strong_valid: torch.Tensor
    surf_weak: torch.Tensor     # [S2, 3]
    surf_weak_valid: torch.Tensor

    def transform(self, q: torch.Tensor, p: torch.Tensor) -> "FeatureCloud":
        def rot(x):
            return lie.quat_rotate(q[None, :], x) + p[None, :]
        return self.replace(
            edge_strong=rot(self.edge_strong), edge_weak=rot(self.edge_weak),
            surf_strong=rot(self.surf_strong), surf_weak=rot(self.surf_weak))


def _grid(xyz: np.ndarray, tgrid: np.ndarray, valid: np.ndarray,
          device) -> RingGrid:
    device = resolve(device)
    return RingGrid(xyz=to_device(xyz, device), time=to_device(tgrid, device),
                    valid=to_device(valid, device))


def organize_scan(points: np.ndarray, rings: np.ndarray,
                  times: Optional[np.ndarray], n_rings: int, width: int,
                  device=None) -> RingGrid:
    """Host-side binning of an unordered scan into a ring-major, azimuth-
    sorted grid, built on ``device`` (the card unless asked otherwise).
    Runs once per scan on ingest, in the host C++ library when a ``g++`` is
    there (a failing build raises), in numpy otherwise."""
    from beam_slam_tpu_torch.ops import native
    device = resolve(device)
    if native.native_available():
        return _grid(*native.organize_scan_native(points, rings, times,
                                                  n_rings, width), device)
    return organize_scan_numpy(points, rings, times, n_rings, width, device)


def organize_scan_numpy(points: np.ndarray, rings: np.ndarray,
                        times: Optional[np.ndarray], n_rings: int, width: int,
                        device=None) -> RingGrid:
    """:func:`organize_scan` in numpy (its plain version): a stable sort by
    (ring, azimuth), then the first ``width`` points of each ring."""
    points = np.asarray(points, np.float32)
    n = len(points)
    if times is None:
        times = np.zeros(n, np.float32)
    az = np.arctan2(points[:, 1], points[:, 0])
    order = np.lexsort((az, rings))
    points, rings, times = (points[order], np.asarray(rings)[order],
                            np.asarray(times, np.float32)[order])

    xyz = np.zeros((n_rings, width, 3), np.float32)
    tgrid = np.zeros((n_rings, width), np.float32)
    valid = np.zeros((n_rings, width), bool)
    for r in range(n_rings):
        sel = rings == r
        m = min(int(sel.sum()), width)
        if m == 0:
            continue
        xyz[r, :m] = points[sel][:m]
        tgrid[r, :m] = times[sel][:m]
        valid[r, :m] = True
    return _grid(xyz, tgrid, valid, device)


def synthetic_structured_scene(n_rings=16, width=512, seed=0,
                               vertical_fov=(-15.0, 15.0),
                               device=None) -> RingGrid:
    """Simulated structured environment scan (walls + poles) for tests: the
    exact ranges a spinning lidar at the origin would measure in an
    axis-aligned box (walls x=±8, y=±6, z=±2.5) with four vertical poles of
    radius 0.15. Host numpy, then moved to ``device``."""
    del seed  # the scene is deterministic; kept for the reference signature
    az = np.linspace(-np.pi, np.pi, width, endpoint=False)
    el = np.deg2rad(np.linspace(vertical_fov[0], vertical_fov[1], n_rings))
    d = np.stack(np.broadcast_arrays(
        np.cos(el)[:, None] * np.cos(az)[None, :],
        np.cos(el)[:, None] * np.sin(az)[None, :],
        np.sin(el)[:, None] * np.ones_like(az)[None, :]), axis=-1)  # [R,W,3]

    t_best = np.full((n_rings, width), np.inf)
    for n_vec, c in [([1, 0, 0], 8.0), ([-1, 0, 0], 8.0), ([0, 1, 0], 6.0),
                     ([0, -1, 0], 6.0), ([0, 0, 1], 2.5), ([0, 0, -1], 2.5)]:
        n_vec = np.asarray(n_vec, np.float64)
        denom = d @ n_vec
        t = np.where(denom > 1e-6, c / np.maximum(denom, 1e-6), np.inf)
        t_best = np.minimum(t_best, t)
    for cx, cy in [(3.0, 2.0), (-2.0, 3.5), (4.0, -3.0), (-5.0, -2.0)]:
        r = 0.15
        dx, dy = d[..., 0], d[..., 1]
        a = dx * dx + dy * dy
        b = -2 * (cx * dx + cy * dy)
        c0 = cx * cx + cy * cy - r * r
        disc = b * b - 4 * a * c0
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                     np.inf)
        t = np.where(t > 0.1, t, np.inf)
        t_best = np.minimum(t_best, t)

    xyz = d * t_best[..., None]
    valid = np.isfinite(t_best) & (t_best < 100.0)
    xyz = np.where(valid[..., None], xyz, 0.0).astype(np.float32)
    # per-point time: one revolution over 0.1 s by azimuth
    tgrid = np.ascontiguousarray(np.broadcast_to(
        ((az + np.pi) / (2 * np.pi) * 0.1)[None, :],
        (n_rings, width)).astype(np.float32))
    return _grid(xyz, tgrid, valid, device)


def transform_grid(grid: RingGrid, q: torch.Tensor, p: torch.Tensor
                   ) -> RingGrid:
    """Rigidly transform every point of the grid."""
    xyz = lie.quat_rotate(q[None, None, :], grid.xyz) + p[None, None, :]
    return grid.replace(xyz=torch.where(grid.valid[..., None], xyz,
                                        torch.zeros_like(xyz)))
