"""ScanContext descriptors for loop-closure candidate search (port of
:mod:`beam_slam_tpu.global_mapping.scancontext`).

Replacement for libbeam's ``beam_matching/Scancontext.h`` as used by
reloc::RelocCandidateSearchScanContext
(bs_models/src/lib/reloc/reloc_candidate_search_scan_context.cpp): a polar
max-height histogram per scan; similarity = min over yaw (column) shifts of
the mean column-wise cosine distance; plus the 1-D "ring key" used for fast
pre-filtering.

Plain torch on the inputs' device, no hand kernel (the reference has no
Pallas kernel here either): the descriptor is one ``scatter_reduce_``
("amax") into a ``-inf``-filled buffer with a trash bin for invalid points;
the distance evaluates all column shifts at once through one gather with a
``[S, S]`` roll index; a database search does every entry in one batched
call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ScanContextConfig(NamedTuple):
    n_rings: int = 20
    n_sectors: int = 60
    max_range: float = 80.0


def make_descriptor(points: torch.Tensor, valid: torch.Tensor,
                    cfg: ScanContextConfig = ScanContextConfig()
                    ) -> torch.Tensor:
    """points [N,3] in the sensor frame → descriptor [n_rings, n_sectors]
    (max z per polar bin; empty bins = 0, matching ScanContext)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y)
    az = torch.atan2(y, x)  # [-pi, pi)
    ring = torch.clamp((r / cfg.max_range * cfg.n_rings).to(torch.int64),
                       0, cfg.n_rings - 1)
    sector = torch.clamp(((az + math.pi) / (2 * math.pi)
                          * cfg.n_sectors).to(torch.int64),
                         0, cfg.n_sectors - 1)
    trash = cfg.n_rings * cfg.n_sectors
    flat = torch.where(valid, ring * cfg.n_sectors + sector,
                       torch.full_like(ring, trash))
    desc = torch.full((trash + 1,), -math.inf, dtype=points.dtype,
                      device=points.device)
    desc.scatter_reduce_(0, flat, torch.where(
        valid, z, torch.full_like(z, -math.inf)), "amax")
    desc = torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))
    return desc[:-1].reshape(cfg.n_rings, cfg.n_sectors)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring key: per-ring occupancy mean. [R,S] → [R]."""
    return torch.mean((desc != 0.0).to(desc.dtype), dim=1)


def _roll_index(S: int, device) -> torch.Tensor:
    """[S, S]: row ``shift`` gathers ``roll(·, shift)`` of S columns."""
    ar = torch.arange(S, device=device)
    return (ar[None, :] - ar[:, None]) % S


def _shift_dists(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Distance of ``desc_a`` [R,S] to ``desc_b`` [..., R, S] rolled by every
    column shift: [..., S]."""
    S = desc_a.shape[1]
    roll = _roll_index(S, desc_a.device)
    b = desc_b[..., roll]                                  # [..., R, S, S]
    num = torch.einsum("rc,...rsc->...sc", desc_a, b)
    den = (torch.linalg.vector_norm(desc_a, dim=0)
           * torch.linalg.vector_norm(desc_b, dim=-2)[..., roll])
    ok = den > 1e-9
    cos = torch.where(ok, num / torch.clamp(den, min=1e-9),
                      torch.zeros_like(num))
    cnt = ok.sum(dim=-1)
    return 1.0 - cos.sum(dim=-1) / torch.clamp(cnt, min=1)


def distance(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """ScanContext distance: min over column shifts of the mean column
    cosine distance. Returns (dist, best_shift)."""
    dists = _shift_dists(desc_a, desc_b)
    best = torch.argmin(dists)
    return dists[best], best


def search(query: torch.Tensor, database: torch.Tensor,
           db_valid: torch.Tensor):
    """Distances of query [R,S] against database [N,R,S] (all shifts, all
    entries at once). Returns (dists [N], best_shifts [N]); invalid entries
    get +inf."""
    dists = _shift_dists(query, database)                  # [N, S]
    shifts = torch.argmin(dists, dim=-1)  # the first of equal minima
    best = torch.gather(dists, -1, shifts[:, None])[:, 0]
    return torch.where(db_valid, best, torch.full_like(best, math.inf)), \
        shifts
