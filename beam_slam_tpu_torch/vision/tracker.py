"""Pyramidal Lucas–Kanade feature tracking (port of
:mod:`beam_slam_tpu.vision.tracker`).

The reference's KLT-style tracker (beam_cv::Tracker driven by
VisualFeatureTracker, bs_models/src/visual_feature_tracker.cpp — detector +
tracker producing per-landmark pixel tracks), as tensor ops on the images'
device: patches are sampled with bilinear gathers, the 2×2 normal equations
are closed-form, and every step runs on the whole feature table at once —
no data-dependent shapes. The Gauss–Newton step is the closed-form one of
the reference (the template's central differences are the Jacobian), so no
autodiff is involved.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class LKConfig(NamedTuple):
    levels: int = 3           # pyramid levels (coarse to fine)
    window: int = 7           # patch side (odd)
    iterations: int = 8       # per-level GN iterations
    min_det: float = 1e-4     # Hessian degeneracy gate
    max_error: float = 12.0   # mean abs photometric error gate (0-255)
    max_motion: float = 60.0  # max total displacement (px, finest level)


def build_pyramid(image: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Simple 2x2 average-pool pyramid, finest first."""
    img = image.to(torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        H, W = img.shape
        img = img[: H // 2 * 2, : W // 2 * 2].reshape(H // 2, 2, W // 2, 2)
        img = img.mean(dim=(1, 3))
        pyr.append(img)
    return pyr


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img at (x, y) locations. xy [..., 2] → [...]."""
    x, y = xy[..., 0], xy[..., 1]
    H, W = img.shape
    # a NaN coordinate samples NaN through fx/fy; its index is made 0 so
    # the gather stays in bounds (an out-of-bounds index faults the card)
    x0f = torch.clamp(torch.nan_to_num(torch.floor(x)), 0, W - 2)
    y0f = torch.clamp(torch.nan_to_num(torch.floor(y)), 0, H - 2)
    fx = torch.clamp(x - x0f, 0.0, 1.0)
    fy = torch.clamp(y - y0f, 0.0, 1.0)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def _window_offsets(cfg: LKConfig, device) -> torch.Tensor:
    """The patch's (dx, dy) offsets, row-major over (dy, dx): [w², 2]."""
    w = cfg.window // 2
    r = torch.arange(-w, w + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def _track_level(prev_img, next_img, pt_prev, pt_next, cfg: LKConfig):
    """One pyramid level of LK for every feature at once: pt_prev and
    pt_next are [N, 2]. Returns (p [N, 2], ok [N], err [N])."""
    offs = _window_offsets(cfg, pt_prev.device)             # [w², 2]
    base = pt_prev[:, None, :] + offs                      # [N, w², 2]
    T = _bilinear(prev_img, base)
    # template gradients (central differences on the prev image)
    hx = torch.tensor([0.5, 0.0], device=base.device)
    hy = torch.tensor([0.0, 0.5], device=base.device)
    gx = _bilinear(prev_img, base + hx) - _bilinear(prev_img, base - hx)
    gy = _bilinear(prev_img, base + hy) - _bilinear(prev_img, base - hy)
    Gxx = torch.sum(gx * gx, dim=1)
    Gxy = torch.sum(gx * gy, dim=1)
    Gyy = torch.sum(gy * gy, dim=1)
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > cfg.min_det
    inv = torch.where(ok, 1.0 / torch.clamp(det, min=cfg.min_det),
                      torch.zeros_like(det))

    p = pt_next
    for _ in range(cfg.iterations):
        e = _bilinear(next_img, p[:, None, :] + offs) - T
        bx = torch.sum(e * gx, dim=1)
        by = torch.sum(e * gy, dim=1)
        dp = -inv[:, None] * torch.stack([Gyy * bx - Gxy * by,
                                          Gxx * by - Gxy * bx], dim=-1)
        p = p + dp
    err = torch.mean(torch.abs(_bilinear(next_img, p[:, None, :] + offs)
                               - T), dim=1)
    return p, ok, err


def track(prev_pyr: Sequence[torch.Tensor], next_pyr: Sequence[torch.Tensor],
          pts: torch.Tensor, valid: torch.Tensor,
          cfg: LKConfig = LKConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track pts [N,2] from prev to next. Returns (new_pts [N,2], ok [N]).

    Coarse-to-fine over the pyramids (finest first in the sequences).
    """
    levels = len(prev_pyr)
    scale = 2.0 ** (levels - 1)
    guess = pts / scale
    ok_all = valid
    err = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        p_prev = pts / s
        new_p, ok_lvl, err = _track_level(prev_pyr[lvl], next_pyr[lvl],
                                          p_prev, guess, cfg)
        ok_all = ok_all & ok_lvl
        guess = torch.where(ok_all[:, None], new_p, p_prev)
        if lvl > 0:
            guess = guess * 2.0
    H, W = prev_pyr[0].shape
    inb = ((guess[:, 0] >= 1) & (guess[:, 0] < W - 1)
           & (guess[:, 1] >= 1) & (guess[:, 1] < H - 1))
    motion_ok = torch.linalg.vector_norm(guess - pts, dim=1) < cfg.max_motion
    ok = ok_all & inb & (err < cfg.max_error) & motion_ok
    return guess, ok
