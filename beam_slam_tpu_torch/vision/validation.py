"""VO localization validation — outlier detection on localization results
(a copy of :mod:`beam_slam_tpu.vision.validation`).

Re-implements ``bs_models::vision::VOLocalizationValidation``
(bs_models/include/bs_models/vision/vo_localization_validation.h:32-63,
src/lib/vision/vo_localization_validation.cpp): each localization yields
metrics (correction rotation angle, correction translation norm, Shannon
entropy of the pose covariance, mean reprojection error). While fewer than
``list_size`` samples exist, fixed initial thresholds gate each metric;
afterwards a rolling window flags a result whose rotation/translation is
outside mean ± 2σ or whose entropy/reprojection is outside mean ± 5σ.

Shannon entropy: H = 0.5·ln[(2πe)^6 · det(cov)] — "the volume of the
uncertainty; the smaller, the more certain" (header docstring, utils.h:79).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Optional

import numpy as np

from beam_slam_tpu_torch.core.utils import \
    shannon_entropy_from_pose_covariance


@dataclasses.dataclass
class VOLocalizationMetrics:
    r: float
    t: float
    entropy: float
    avg_reprojection: float


class VOLocalizationValidation:
    """Rolling statistical gate. Defaults mirror the reference
    (vo_localization_validation.h:57-63)."""

    def __init__(self, list_size: int = 15, t_init_thresh: float = 0.5,
                 r_init_thresh: float = math.pi / 6,
                 entropy_init_thresh: float = -10.0,
                 reproj_init_thresh: float = 10.0):
        self.list_size = list_size
        self.t_init_thresh = t_init_thresh
        self.r_init_thresh = r_init_thresh
        self.entropy_init_thresh = entropy_init_thresh
        self.reproj_init_thresh = reproj_init_thresh
        self.metrics: Deque[VOLocalizationMetrics] = deque(maxlen=list_size)
        self.last_failure: Optional[str] = None

    def clear(self):
        self.metrics.clear()
        self.last_failure = None

    def validate(self, correction_rot_angle: float,
                 correction_translation: float,
                 covariance: np.ndarray,
                 avg_reprojection: float) -> bool:
        """Deviation from the reference: the rolling mean/σ are computed over
        the PRIOR window, excluding the candidate (the reference pushes the
        sample first, vo_localization_validation.cpp:23-31 — but a sample
        inside its own N=15 statistics is bounded to ~3.7σ, so its 5σ
        entropy/reprojection gates can mathematically never fire; excluding
        the candidate restores the documented intent). Rejected samples do
        not enter the statistics."""
        m = VOLocalizationMetrics(
            r=float(correction_rot_angle),
            t=float(correction_translation),
            entropy=float(shannon_entropy_from_pose_covariance(covariance)),
            avg_reprojection=float(avg_reprojection))
        warmed = len(self.metrics) >= self.list_size
        ok = (self._check_stored(m) if warmed else self._check_initial(m))
        if ok:
            self.metrics.append(m)
        return ok

    def _check_initial(self, m: VOLocalizationMetrics) -> bool:
        if m.t > self.t_init_thresh:
            self.last_failure = f"translation {m.t:.3f} > {self.t_init_thresh}"
            return False
        if m.r > self.r_init_thresh:
            self.last_failure = f"rotation {m.r:.3f} > {self.r_init_thresh}"
            return False
        if m.entropy > self.entropy_init_thresh:
            self.last_failure = (f"entropy {m.entropy:.2f} > "
                                 f"{self.entropy_init_thresh}")
            return False
        if m.avg_reprojection > self.reproj_init_thresh:
            self.last_failure = (f"reprojection {m.avg_reprojection:.2f} > "
                                 f"{self.reproj_init_thresh}")
            return False
        self.last_failure = None
        return True

    def _check_stored(self, m: VOLocalizationMetrics) -> bool:
        arr = np.array([[s.r, s.t, s.entropy, s.avg_reprojection]
                        for s in self.metrics])
        mean = arr.mean(axis=0)
        std = arr.std(axis=0)
        recent = np.array([m.r, m.t, m.entropy, m.avg_reprojection])
        names = ("rotation", "translation", "entropy", "reprojection")
        sigmas = (2.0, 2.0, 5.0, 5.0)
        for k, (name, ns) in enumerate(zip(names, sigmas)):
            if abs(recent[k] - mean[k]) > ns * std[k] + 1e-12:
                self.last_failure = (f"{name} {recent[k]:.3f} outside mean "
                                     f"{mean[k]:.3f} ± {ns}σ ({std[k]:.3f})")
                return False
        self.last_failure = None
        return True
