"""Visual feature tracker model: image stream → per-landmark pixel tracks
(port of :mod:`beam_slam_tpu.models.visual_feature_tracker`).

Re-implements the reference ``VisualFeatureTracker`` plugin
(bs_models/src/visual_feature_tracker.cpp, header :18-93): detector +
tracker producing CameraMeasurementMsg-equivalents (landmark id + pixel per
feature). The beam_cv FASTSSC/ORB/KLT stack maps to the FAST and
pyramidal-LK tensor functions (:mod:`beam_slam_tpu_torch.vision.detector`
/ :mod:`beam_slam_tpu_torch.vision.tracker`), which run on ``device`` (the
card unless asked otherwise); descriptor extraction is not needed for the
LK pipeline (descriptors return with the reloc/ImageDatabase layer).

Host-side bookkeeping (ids, replenishment) wraps the tensor functions; the
feature table has fixed capacity = one feature per detector grid cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from beam_slam_tpu_torch.device import resolve, to_device, to_numpy
from beam_slam_tpu_torch.vision import detector as det
from beam_slam_tpu_torch.vision import tracker as trk
from beam_slam_tpu_torch.vision.camera import PinholeRadtan


class CameraMeasurement(NamedTuple):
    """One frame's tracked features (CameraMeasurementMsg equivalent,
    bs_common/msg/CameraMeasurementMsg.msg), as host arrays."""

    stamp: float
    ids: np.ndarray        # [M] landmark ids
    pixels: np.ndarray     # [M, 2] raw pixels
    pixels_undistorted: np.ndarray  # [M, 2]


class VisualFeatureTracker:
    def __init__(self, camera: PinholeRadtan,
                 fast_cfg: det.FastConfig = det.FastConfig(threshold=15.0),
                 lk_cfg: trk.LKConfig = trk.LKConfig(),
                 min_features: int = 40, device=None):
        self.camera = camera
        self.fast_cfg = fast_cfg
        self.lk_cfg = lk_cfg
        self.min_features = min_features
        self.device = resolve(device)
        self.prev_pyr = None
        self.xy = None          # [N, 2]
        self.ids = None         # [N]
        self.valid = None       # [N]
        self.next_id = 0

    def _replenish(self, xy_new: np.ndarray, det_valid: np.ndarray,
                   width: int):
        """Fill empty feature slots with fresh detections in unoccupied
        cells (the spatial-suppression role of FASTSSC)."""
        c = self.fast_cfg.cell_size
        n_wc = width // c
        occupied = set()
        for i in range(len(self.xy)):
            if self.valid[i]:
                occupied.add((int(self.xy[i, 1]) // c) * n_wc
                             + int(self.xy[i, 0]) // c)
        for j in range(len(xy_new)):
            if not det_valid[j]:
                continue
            cell = (int(xy_new[j, 1]) // c) * n_wc + int(xy_new[j, 0]) // c
            if cell in occupied:
                continue
            # place into a free table slot
            free = np.nonzero(~self.valid)[0]
            if len(free) == 0:
                break
            s = free[0]
            self.xy[s] = xy_new[j]
            self.ids[s] = self.next_id
            self.next_id += 1
            self.valid[s] = True
            occupied.add(cell)

    def process_image(self, stamp: float, image) -> CameraMeasurement:
        """Track the table into ``image`` ([H, W] intensities, host array or
        tensor), refill free cells from its detections, and return the
        frame's measurement."""
        if isinstance(image, torch.Tensor):
            image = image.to(self.device, torch.float32)
        else:
            image = to_device(np.asarray(image, np.float32), self.device)
        pyr = tuple(trk.build_pyramid(image, self.lk_cfg.levels))
        if self.prev_pyr is None:
            H, W = image.shape
            c = self.fast_cfg.cell_size
            n = (H // c) * (W // c)
            self.xy = np.zeros((n, 2), np.float32)
            self.ids = np.full(n, -1, np.int64)
            self.valid = np.zeros(n, bool)
            xy_new, _, det_valid = det.detect(image, self.fast_cfg)
            xy_new, det_valid = to_numpy(xy_new, det_valid)
        else:
            new_xy, ok = trk.track(self.prev_pyr, pyr,
                                   to_device(self.xy, self.device),
                                   to_device(self.valid, self.device),
                                   self.lk_cfg)
            xy_new, _, det_valid = det.detect(image, self.fast_cfg)
            # one wait for the tracks and the detections together
            new_xy, ok, xy_new, det_valid = to_numpy(new_xy, ok, xy_new,
                                                     det_valid)
            self.xy = new_xy.copy()
            self.valid = self.valid & ok
        self._replenish(xy_new, det_valid.copy(), int(image.shape[1]))
        self.prev_pyr = pyr

        sel = self.valid
        pix = self.xy[sel]
        und = (to_numpy(self.camera.undistort_pixel(
            torch.from_numpy(pix)))[0] if len(pix) else pix)
        return CameraMeasurement(stamp=stamp, ids=self.ids[sel].copy(),
                                 pixels=pix.copy(),
                                 pixels_undistorted=np.asarray(und))
