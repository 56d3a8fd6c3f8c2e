"""LOAM feature extraction on the ring grid (port of
:mod:`beam_slam_tpu.lidar.features`).

Ring-wise curvature over the azimuth-sorted grid, per-sector selection of
sharp edge points and flat surface points with a strong/weak split; regular
masked tensor math on the [R, W] grid (circular neighbourhoods via roll,
per-(ring, sector) selection via a sort), static output shapes.

Selection: the reference takes ``jax.lax.top_k``, which breaks ties by the
lower index. ``torch.topk`` leaves the order of ties open, and the masked
``-inf`` entries all tie, so the port sorts instead: a stable descending
sort keeps ties in index order, which gives the reference's picks and their
order exactly (``RegistrationMap._pack`` compacts the valid picks in that
order).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from beam_slam_tpu_torch.lidar.cloud import FeatureCloud, RingGrid


class LoamConfig(NamedTuple):
    """Defaults follow LOAM/A-LOAM conventions; tunable via the JSON config
    layer (matchers/loam_*.json)."""

    n_sectors: int = 6
    neighbors: int = 5            # curvature half-window
    edge_strong_per_sector: int = 2
    edge_weak_per_sector: int = 20
    surf_strong_per_sector: int = 4
    surf_weak_stride: int = 4     # subsample of remaining flat points
    edge_curvature_min: float = 0.1
    surf_curvature_max: float = 0.1
    min_range: float = 0.3
    max_range: float = 120.0
    occlusion_ratio: float = 1.15  # neighbor range jump gate


def curvature(grid: RingGrid, cfg: LoamConfig):
    """Per-point LOAM curvature and pickability mask. [R, W] each."""
    xyz, valid = grid.xyz, grid.valid
    r = torch.linalg.vector_norm(xyz, dim=-1)
    valid = valid & (r > cfg.min_range) & (r < cfg.max_range)

    k = cfg.neighbors
    acc = -2.0 * k * xyz
    nb_valid = valid
    range_jump = torch.zeros_like(valid)
    for off in range(1, k + 1):
        for s in (-off, off):
            acc = acc + torch.roll(xyz, s, dims=1)
            nb_valid = nb_valid & torch.roll(valid, s, dims=1)
            if off == 1:
                r_s = torch.roll(r, s, dims=1)
                ratio = torch.maximum(r, r_s) / torch.clamp(
                    torch.minimum(r, r_s), min=1e-3)
                range_jump = range_jump | (ratio > cfg.occlusion_ratio)

    c = torch.sum(acc * acc, dim=-1) / torch.clamp(r * r, min=1e-6)
    pickable = nb_valid & ~range_jump
    return c, pickable


def _select_top(xyz_sec, score_sec, mask_sec, k, stride=1):
    """Per-(ring,sector) top-k by score over the sector axis.
    xyz_sec: [R, NS, Ws, 3]; score/mask: [R, NS, Ws]. Returns ([R*NS*k', 3],
    [R*NS*k']) with k' = ceil(k/stride)."""
    s = torch.where(mask_sec, score_sec,
                    torch.full_like(score_sec, -math.inf))
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if stride > 1:
        vals = vals[..., ::stride]
        idx = idx[..., ::stride]
    picked = torch.gather(xyz_sec, 2,
                          idx[..., None].expand(idx.shape + (3,)))
    ok = torch.isfinite(vals)
    R, NS, kk = vals.shape
    return picked.reshape(R * NS * kk, 3), ok.reshape(R * NS * kk)


def extract_features(grid: RingGrid, cfg: LoamConfig = LoamConfig()
                     ) -> FeatureCloud:
    """Full LOAM feature extraction on the grid's device. Output caps are
    static functions of (R, n_sectors, cfg)."""
    R, W = grid.valid.shape
    NS = cfg.n_sectors
    if W % NS:
        raise ValueError(f"grid width {W} must divide into {NS} sectors")
    Ws = W // NS

    c, pickable = curvature(grid, cfg)
    xyz_sec = grid.xyz.reshape(R, NS, Ws, 3)
    c_sec = c.reshape(R, NS, Ws)
    ok_sec = pickable.reshape(R, NS, Ws)

    edge_mask = ok_sec & (c_sec > cfg.edge_curvature_min)
    surf_mask = ok_sec & (c_sec < cfg.surf_curvature_max)

    e_s, e_s_ok = _select_top(xyz_sec, c_sec, edge_mask,
                              cfg.edge_strong_per_sector)
    e_w, e_w_ok = _select_top(xyz_sec, c_sec, edge_mask,
                              cfg.edge_weak_per_sector)
    s_s, s_s_ok = _select_top(xyz_sec, -c_sec, surf_mask,
                              cfg.surf_strong_per_sector)
    # weak surfaces: every flat point, stride-subsampled for spread
    s_w, s_w_ok = _select_top(xyz_sec, -c_sec, surf_mask, Ws,
                              stride=cfg.surf_weak_stride)
    return FeatureCloud(
        edge_strong=e_s, edge_strong_valid=e_s_ok,
        edge_weak=e_w, edge_weak_valid=e_w_ok,
        surf_strong=s_s, surf_strong_valid=s_s_ok,
        surf_weak=s_w, surf_weak_valid=s_w_ok)
