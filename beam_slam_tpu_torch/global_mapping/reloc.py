"""Relocalization / loop-closure: candidate search + refinement (port of
:mod:`beam_slam_tpu.global_mapping.reloc`).

Re-implements bs_models/lib/reloc (SURVEY.md §2.4):
  * RelocCandidateSearchBase/EucDist (reloc_candidate_search_base.h:11-45):
    candidate submaps by euclidean distance between submap positions;
  * RelocCandidateSearchScanContext (reloc_candidate_search_scan_context.cpp):
    ScanContext descriptor matching over the submap database (batched);
  * RelocRefinementLoam (reloc_refinement_loam_registration.{h,cpp}):
    submap-to-submap LOAM registration (``lidar.registration.register_loam``,
    kernel K2 on the card) →
    RelocRefinementResults{T_MATCH_QUERY, covariance, successful}.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.device import to_device, to_numpy
from beam_slam_tpu_torch.global_mapping import scancontext as sc
from beam_slam_tpu_torch.global_mapping.submap import Submap
from beam_slam_tpu_torch.lidar import registration as reg
from beam_slam_tpu_torch.lidar.cloud import FeatureCloud


class RelocResult(NamedTuple):
    """RelocRefinementResults (reloc_refinement_base.h:24-56)."""
    successful: bool
    dq: np.ndarray   # T_MATCH_QUERY rotation (match frame → query frame map)
    dp: np.ndarray
    information: np.ndarray  # [6, 6]


@dataclasses.dataclass
class EuclideanCandidateSearch:
    """Distance-based candidate search (reloc_candidate_search_eucdist)."""

    max_distance_m: float = 10.0
    skip_recent: int = 2   # never match against the most recent N submaps

    def find(self, submaps: List[Submap], query_idx: int,
             max_candidates: int = 3) -> List[int]:
        q_pos = submaps[query_idx].p
        cands = []
        for i, sm in enumerate(submaps):
            # never the query itself; skip the most recent `skip_recent`
            # submaps preceding it
            if i >= query_idx - self.skip_recent:
                continue
            d = float(np.linalg.norm(np.asarray(sm.p) - np.asarray(q_pos)))
            if d < self.max_distance_m:
                cands.append((d, i))
        cands.sort()
        return [i for _, i in cands[:max_candidates]]


@dataclasses.dataclass
class ScanContextCandidateSearch:
    """Descriptor-based candidate search. Submap descriptors are built from
    the aggregated submap feature cloud (submap frame), on the submap's
    device, and kept as host arrays."""

    config: sc.ScanContextConfig = sc.ScanContextConfig()
    max_distance: float = 0.25   # descriptor distance gate
    skip_recent: int = 2

    def describe(self, submap: Submap) -> np.ndarray:
        e, ev, s, sv = submap.aggregate_features_submap_frame()
        pts = torch.cat([e, s])
        valid = torch.cat([ev, sv])
        if len(pts) == 0:
            return np.zeros((self.config.n_rings, self.config.n_sectors),
                            np.float32)
        return to_numpy(sc.make_descriptor(pts, valid, self.config))[0]

    def find(self, submaps: List[Submap], query_idx: int,
             max_candidates: int = 3) -> List[int]:
        query = submaps[query_idx]
        if query.descriptor is None:
            query.descriptor = self.describe(query)
        db, idxs = [], []
        for i, sm in enumerate(submaps):
            if i >= query_idx - self.skip_recent:
                continue
            if sm.descriptor is None:
                sm.descriptor = self.describe(sm)
            db.append(sm.descriptor)
            idxs.append(i)
        if not db:
            return []
        dev = query.device
        dists, _ = sc.search(
            to_device(np.asarray(query.descriptor, np.float32), dev),
            to_device(np.stack(db).astype(np.float32), dev),
            torch.ones(len(db), dtype=torch.bool, device=dev))
        dists = to_numpy(dists)[0]
        order = np.argsort(dists)
        return [idxs[j] for j in order[:max_candidates]
                if dists[j] < self.max_distance]


@dataclasses.dataclass
class LoamRelocRefinement:
    """Submap-to-submap LOAM registration refinement
    (reloc_refinement_loam_registration.cpp)."""

    # large-correction offline registration: refit correspondences every
    # GN step (accuracy over speed)
    reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(
        iterations=10, corr_refits=10, max_corr_dist=2.0)
    max_correction_trans_m: float = 5.0

    def refine(self, match: Submap, query: Submap) -> RelocResult:
        """Estimate T_MATCH_QUERY: the pose of the query submap frame
        expressed in the match submap frame. Seed from the current world
        pose estimates. Both submaps on one device."""
        me, mev, ms, msv = match.aggregate_features_submap_frame()
        if len(me) == 0:
            return RelocResult(False, np.array([1, 0, 0, 0], np.float32),
                               np.zeros(3, np.float32),
                               np.eye(6, dtype=np.float32))
        # seed: T_MATCH_QUERY = T_WORLD_MATCH⁻¹ · T_WORLD_QUERY
        q_mw = lie.quat_conj(np.asarray(match.q, np.float32))
        dq0 = lie.quat_mul(q_mw, np.asarray(query.q, np.float32))
        dp0 = lie.quat_rotate(q_mw, np.asarray(query.p, np.float32)
                              - np.asarray(match.p, np.float32))

        # query features as a FeatureCloud in the query submap frame
        qe, qev, qs, qsv = query.aggregate_features_submap_frame()
        if len(qe) == 0:
            return RelocResult(False, dq0, dp0, np.eye(6, dtype=np.float32))
        dev = me.device
        z3 = torch.zeros((0, 3), dtype=me.dtype, device=dev)
        zb = torch.zeros((0,), dtype=torch.bool, device=dev)
        fc = FeatureCloud(
            edge_strong=qe, edge_strong_valid=qev, edge_weak=z3,
            edge_weak_valid=zb, surf_strong=qs, surf_strong_valid=qsv,
            surf_weak=z3, surf_weak_valid=zb)
        res = reg.register_loam(fc, me, mev, ms, msv, to_device(dq0, dev),
                                to_device(dp0, dev), self.reg_cfg)
        q, p, info, conv = to_numpy(res.q, res.p, res.information,
                                    res.converged)
        ok = bool(conv)
        corr = float(np.linalg.norm(p - dp0))
        if corr > self.max_correction_trans_m:
            ok = False
        return RelocResult(ok, q, p, info)


# -- JSON config factories (RelocCandidateSearchBase::Create /
#    RelocRefinementBase::Create analogs; schemas follow
#    beam_slam_launch/config/global_map/reloc_*.json) ----------------------

def create_candidate_search(source, config_root: Optional[str] = None):
    """reloc_candidate_search_{eucdist,scan_context}.json → search object."""
    from beam_slam_tpu_torch.lidar.scan_registration import _load_json
    cfg = _load_json(source, config_root)
    t = cfg.get("type", "EUCDIST").upper()
    if t == "EUCDIST":
        return EuclideanCandidateSearch(
            max_distance_m=float(cfg.get("distance_threshold_m", 10.0)))
    if t in ("SCANCONTEXT", "SCAN_CONTEXT"):
        return ScanContextCandidateSearch(
            max_distance=float(cfg.get("scan_context_dist_thres", 0.25)))
    raise ValueError(f"unknown candidate search type {t!r}")


def create_reloc_refinement(source, config_root: Optional[str] = None):
    """reloc_refinement_loam_registration.json → refinement object. The
    matcher_config sub-file supplies correspondence distance/iterations."""
    from beam_slam_tpu_torch.lidar.scan_registration import _load_json
    cfg = _load_json(source, config_root)
    t = cfg.get("type", "LOAM").upper()
    if t != "LOAM":
        raise ValueError(f"reloc refinement type {t!r} not implemented "
                         "(reference ships LOAM only for submaps)")
    kwargs = {}
    if cfg.get("matcher_config"):
        m = _load_json(cfg["matcher_config"], config_root)
        refits = int(m.get("max_correspondence_iterations", 7)) + 3
        kwargs["reg_cfg"] = reg.LoamRegistrationConfig(
            iterations=refits, corr_refits=refits,
            max_corr_dist=float(m.get("max_correspondence_distance", 2.0)))
    return LoamRelocRefinement(**kwargs)
