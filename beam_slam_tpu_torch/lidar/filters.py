"""Lidar input-filter tier — the pre-feature-extraction cleanup stage (port
of :mod:`beam_slam_tpu.lidar.filters`).

Re-implements the reference's input-filter chain: LidarOdometry loads a JSON
filter list (``input_filters_config``, bs_models/src/lidar_odometry.cpp:37-45)
of beam_filtering filters; the shipped configs use CROPBOX entries
(beam_slam_launch/config/lidar_filters/input_filters_cropbox.json — a small
box with ``remove_outside_points: false`` to cut the robot's own body out of
the scan, plus a large box with ``remove_outside_points: true`` to bound
range), and beam_filtering additionally provides VOXEL downsampling and DROR
radius-outlier removal.

Filters never resize — they clear ``valid`` bits on the fixed-shape
:class:`~beam_slam_tpu_torch.lidar.cloud.RingGrid`, on the grid's device
(the feature extractor and matchers already honor the mask).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence, Union

import numpy as np
import torch

from beam_slam_tpu_torch.lidar.cloud import RingGrid
from beam_slam_tpu_torch.lidar.registration_map import _wrap_int32


@dataclasses.dataclass(frozen=True)
class CropBoxFilter:
    """CROPBOX: with ``remove_outside_points`` keep only points inside the
    box; otherwise remove the points inside it (self-hit removal)."""

    min: tuple
    max: tuple
    remove_outside_points: bool = True


@dataclasses.dataclass(frozen=True)
class VoxelDownsampleFilter:
    """VOXEL: keep one point per occupied voxel (the first in scan order)."""

    voxel_size: float = 0.1


@dataclasses.dataclass(frozen=True)
class RadiusOutlierFilter:
    """DROR-style dynamic radius outlier removal: a point survives if at
    least ``min_neighbors`` other points lie within ``radius_multiplier`` ×
    (azimuth arc length at its range)."""

    radius_multiplier: float = 3.0
    azimuth_res_deg: float = 0.4
    min_neighbors: int = 3
    min_search_radius: float = 0.04


Filter = Union[CropBoxFilter, VoxelDownsampleFilter, RadiusOutlierFilter]


def load_filters(source: Union[str, dict]) -> List[Filter]:
    """Parse a reference-style filter JSON ({"filters": [...]}) — same
    ``filter_type`` strings and keys as beam_slam_launch/config/
    lidar_filters/input_filters_cropbox.json."""
    if isinstance(source, str):
        with open(source) as f:
            source = json.load(f)
    out: List[Filter] = []
    for spec in source.get("filters", []):
        ftype = spec["filter_type"].upper()
        if ftype == "CROPBOX":
            out.append(CropBoxFilter(
                min=tuple(spec["min"]), max=tuple(spec["max"]),
                remove_outside_points=bool(
                    spec.get("remove_outside_points", True))))
        elif ftype == "VOXEL":
            out.append(VoxelDownsampleFilter(
                voxel_size=float(spec.get("voxel_size", 0.1))))
        elif ftype in ("DROR", "RADIUS_OUTLIER"):
            out.append(RadiusOutlierFilter(
                radius_multiplier=float(spec.get("radius_multiplier", 3.0)),
                azimuth_res_deg=float(spec.get("azimuth_res_deg", 0.4)),
                min_neighbors=int(spec.get("min_neighbors", 3)),
                min_search_radius=float(spec.get("min_search_radius", 0.04))))
        else:
            raise ValueError(f"unknown filter_type {ftype}")
    return out


def _apply_cropbox(grid: RingGrid, f: CropBoxFilter) -> RingGrid:
    lo = torch.tensor(f.min, dtype=grid.xyz.dtype, device=grid.xyz.device)
    hi = torch.tensor(f.max, dtype=grid.xyz.dtype, device=grid.xyz.device)
    inside = torch.all((grid.xyz >= lo) & (grid.xyz <= hi), dim=-1)
    keep = inside if f.remove_outside_points else ~inside
    return grid.replace(valid=grid.valid & keep)


def _apply_voxel(grid: RingGrid, f: VoxelDownsampleFilter) -> RingGrid:
    R, W, _ = grid.xyz.shape
    pts = grid.xyz.reshape(-1, 3)
    valid = grid.valid.reshape(-1)
    # a full-tensor divisor: division by a scalar becomes a product with its
    # reciprocal, which can move a point on a voxel face
    cell = torch.floor(pts / torch.full_like(pts, f.voxel_size)).to(
        torch.int64)
    # hash cells to a table (int32 products that wrap, as the reference's);
    # the first valid point in scan order wins
    h = (_wrap_int32(cell[:, 0] * 73856093)
         ^ _wrap_int32(cell[:, 1] * 19349663)
         ^ _wrap_int32(cell[:, 2] * 83492791)) & 0xFFFFF
    order = torch.arange(pts.shape[0], dtype=torch.int64, device=pts.device)
    slot = torch.where(valid, h, torch.full_like(h, 0x100000))
    table = torch.full((0x100001,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=pts.device)
    table.scatter_reduce_(0, slot, order, reduce="amin")
    keep = valid & (table[slot] == order)
    return grid.replace(valid=keep.reshape(R, W))


def _apply_dror(grid: RingGrid, f: RadiusOutlierFilter) -> RingGrid:
    """Neighborhood test along each ring (the dominant density axis of a
    spinning lidar): count within-radius neighbors among the ±K nearest
    azimuth bins of the same and adjacent rings."""
    R, W, _ = grid.xyz.shape
    rng = torch.sqrt(torch.sum(grid.xyz * grid.xyz, dim=-1))
    search_r = torch.clamp(
        f.radius_multiplier * rng
        * float(np.float32(np.deg2rad(f.azimuth_res_deg))),
        min=f.min_search_radius)
    K = 4
    count = torch.zeros((R, W), dtype=torch.int32, device=grid.xyz.device)
    for dr in (-1, 0, 1):
        for dw in range(-K, K + 1):
            if dr == 0 and dw == 0:
                continue
            nb = torch.roll(grid.xyz, shifts=(dr, dw), dims=(0, 1))
            nb_valid = torch.roll(grid.valid, shifts=(dr, dw), dims=(0, 1))
            diff = grid.xyz - nb
            d = torch.sqrt(torch.sum(diff * diff, dim=-1))
            count = count + (nb_valid & (d < search_r)).to(torch.int32)
    return grid.replace(valid=grid.valid & (count >= f.min_neighbors))


def apply_filters(grid: RingGrid, filters: Sequence[Filter]) -> RingGrid:
    """Apply the filter chain in order, on the grid's device."""
    for f in filters:
        if isinstance(f, CropBoxFilter):
            grid = _apply_cropbox(grid, f)
        elif isinstance(f, VoxelDownsampleFilter):
            grid = _apply_voxel(grid, f)
        elif isinstance(f, RadiusOutlierFilter):
            grid = _apply_dror(grid, f)
        else:
            raise ValueError(f)
    return grid
