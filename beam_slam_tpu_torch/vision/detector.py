"""FAST corner detection with grid-cell spatial suppression (port of
:mod:`beam_slam_tpu.vision.detector`).

The reference's detector stage (VisualFeatureTracker uses beam_cv FASTSSC
detection — bs_models/src/visual_feature_tracker.cpp; FAST corners plus
spatial suppression for even coverage), as tensor ops on the image's
device: the 16-point Bresenham circle is 16 shifted views of the image
(``torch.roll``), arc contiguity a stacked window-AND, and suppression one
winner per grid cell — a fixed feature capacity of one per cell.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# FAST circle of radius 3 (Bresenham), clockwise from 12 o'clock: (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class FastConfig(NamedTuple):
    threshold: float = 20.0      # intensity threshold (0-255 scale)
    arc_length: int = 9          # FAST-9
    cell_size: int = 32          # suppression grid cell (px)
    border: int = 4


def fast_score(image: torch.Tensor, cfg: FastConfig = FastConfig()
               ) -> torch.Tensor:
    """Per-pixel FAST corner score ([H, W]; 0 where not a corner)."""
    img = image.to(torch.float32)
    shifted = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                           for dy, dx in _CIRCLE])          # [16, H, W]
    diff = shifted - img[None]
    bright = diff > cfg.threshold
    dark = diff < -cfg.threshold

    def contiguous(mask):
        ext = torch.cat([mask, mask[: cfg.arc_length - 1]], dim=0)
        hit = torch.zeros_like(mask[0])
        for k in range(16):
            hit = hit | torch.all(ext[k: k + cfg.arc_length], dim=0)
        return hit

    corner = contiguous(bright) | contiguous(dark)
    score = torch.sum(torch.clamp(diff.abs() - cfg.threshold, min=0.0), dim=0)
    score = torch.where(corner, score, torch.zeros_like(score))
    # zero the border
    H, W = img.shape
    b = cfg.border
    inside = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inside[b:H - b, b:W - b] = True
    return torch.where(inside, score, torch.zeros_like(score))


def detect(image: torch.Tensor, cfg: FastConfig = FastConfig()
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect corners with one winner per grid cell (the first in row-major
    order on a tie).

    Returns (xy [N, 2] float32 (x, y), score [N], valid [N]) with
    N = (H // cell) * (W // cell), fixed for a given image size.
    """
    score = fast_score(image, cfg)
    H, W = score.shape
    c = cfg.cell_size
    Hc, Wc = H // c, W // c
    s = score[: Hc * c, : Wc * c].reshape(Hc, c, Wc, c)
    s = s.permute(0, 2, 1, 3).reshape(Hc, Wc, c * c)
    best_score, best = torch.max(s, dim=-1)
    dy = best // c
    dx = best % c
    rows = torch.arange(Hc, device=score.device)[:, None]
    cols = torch.arange(Wc, device=score.device)[None, :]
    yy = rows * c + dy
    xx = cols * c + dx
    xy = torch.stack([xx, yy], dim=-1).reshape(-1, 2).to(torch.float32)
    best_score = best_score.reshape(-1)
    return xy, best_score, best_score > 0.0
