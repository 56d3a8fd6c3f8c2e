"""Calibration viewer (port of :mod:`beam_slam_tpu.obs.calibration_viewer`)
— project lidar scans into the camera to visually verify extrinsics and
intrinsics.

Re-implements ``bs_tools`` ``calibration_viewer_node``
(bs_tools/src/calibration_viewer_node.cpp): the node overlays the
(motion-compensated) lidar points onto camera images through
T_CAMERA_LIDAR and the camera model, publishing the annotated image. Here
the overlay renders to a portable PPM (plus a frustum/axes PLY via
obs.artifacts) — same verification signal, file artifacts instead of ROS
topics. The projection runs on the scan's device (the card unless the
caller gives host arrays and another ``device``); the overlay is host
numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.device import resolve, to_numpy


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def project_scan_to_camera(xyz_lidar, valid, q_bl, p_bl, q_bc, p_bc,
                           camera, image_wh: Tuple[int, int] = (640, 480),
                           device=None):
    """Lidar-frame points → camera pixels through the calibration chain
    T_CAMERA_LIDAR = T_BASELINK_CAMERA⁻¹ · T_BASELINK_LIDAR.

    ``xyz_lidar`` [..., 3] and ``valid`` [...] are tensors (the projection
    runs on their device) or host arrays (it runs on ``device``: the card
    unless given). Returns host numpy (uv [N,2], depth [N], ok [N]) — ok
    requires valid input, positive depth, and landing inside
    ``image_wh``."""
    dev = (xyz_lidar.device if isinstance(xyz_lidar, torch.Tensor)
           and device is None else resolve(device))
    pts = _f32(xyz_lidar, dev).reshape(-1, 3)
    v = torch.as_tensor(valid, device=dev).reshape(-1).bool()
    q_bl, p_bl, q_bc, p_bc = (_f32(a, dev) for a in (q_bl, p_bl, q_bc, p_bc))

    # lidar → baselink
    X_b = lie.quat_rotate(q_bl[None], pts) + p_bl[None]
    # baselink → camera
    X_c = lie.quat_rotate(lie.quat_conj(q_bc)[None], X_b - p_bc[None])
    depth = X_c[:, 2]
    uv, in_model = camera.project(X_c)
    W, H = image_wh
    ok = (v & in_model & (depth > 0.1)
          & (uv[:, 0] >= 0) & (uv[:, 0] < W)
          & (uv[:, 1] >= 0) & (uv[:, 1] < H))
    return tuple(to_numpy(uv, depth, ok))


def render_overlay_ppm(path: str, uv: np.ndarray, depth: np.ndarray,
                       ok: np.ndarray, image_wh: Tuple[int, int] = (640, 480),
                       image: Optional[np.ndarray] = None,
                       point_radius: int = 1):
    """Write a binary PPM with the projected points colormapped by depth
    (near=red → far=blue) over ``image`` (grayscale [H,W] or None)."""
    W, H = image_wh
    if image is not None:
        img = np.repeat(np.asarray(image, np.uint8)[:, :, None], 3, axis=2)
    else:
        img = np.full((H, W, 3), 40, np.uint8)
    sel = np.nonzero(ok)[0]
    if len(sel):
        d = depth[sel]
        t = np.clip((d - d.min()) / max(d.max() - d.min(), 1e-6), 0, 1)
        colors = np.stack([255 * (1 - t), 64 * np.ones_like(t), 255 * t],
                          axis=1).astype(np.uint8)
        for (u, v), c in zip(uv[sel].astype(int), colors):
            y0, y1 = max(v - point_radius, 0), min(v + point_radius + 1, H)
            x0, x1 = max(u - point_radius, 0), min(u + point_radius + 1, W)
            img[y0:y1, x0:x1] = c
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (W, H))
        f.write(img.tobytes())
    return img


def write_calibration_artifacts(directory: str, calib, grid=None,
                                image_wh: Tuple[int, int] = (640, 480)):
    """Dump the calibration visualization artifacts: sensor-frame frustums
    (PLY) and, when a scan (a RingGrid) is given, the lidar→camera overlay
    (PPM), projected on the grid's device."""
    from beam_slam_tpu_torch.obs.artifacts import pose_frustum_cloud, write_ply

    os.makedirs(directory, exist_ok=True)
    frames = []
    ident = np.array([1, 0, 0, 0], np.float32)
    frames.append(pose_frustum_cloud(ident, np.zeros(3)))  # baselink
    if calib.q_baselink_cam is not None:
        frames.append(pose_frustum_cloud(np.asarray(calib.q_baselink_cam),
                                         np.asarray(calib.p_baselink_cam)))
    if calib.q_baselink_lidar is not None:
        frames.append(pose_frustum_cloud(np.asarray(calib.q_baselink_lidar),
                                         np.asarray(calib.p_baselink_lidar)))
    write_ply(os.path.join(directory, "extrinsic_frames.ply"),
              np.concatenate(frames))
    out = dict(frames_ply=os.path.join(directory, "extrinsic_frames.ply"))
    if grid is not None and calib.camera is not None \
            and calib.q_baselink_cam is not None:
        q_bl = (calib.q_baselink_lidar if calib.q_baselink_lidar is not None
                else np.array([1, 0, 0, 0], np.float32))
        p_bl = (calib.p_baselink_lidar if calib.p_baselink_lidar is not None
                else np.zeros(3, np.float32))
        uv, depth, ok = project_scan_to_camera(
            grid.xyz, grid.valid, q_bl, p_bl, calib.q_baselink_cam,
            calib.p_baselink_cam, calib.camera, image_wh)
        ppm = os.path.join(directory, "lidar_overlay.ppm")
        render_overlay_ppm(ppm, uv, depth, ok, image_wh)
        out.update(overlay_ppm=ppm, n_projected=int(ok.sum()))
    return out
