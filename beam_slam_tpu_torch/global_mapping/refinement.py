"""Offline global-map refinement pipeline (port of
:mod:`beam_slam_tpu.global_mapping.refinement`).

Re-implements ``bs_models::global_mapping::GlobalMapRefinement``
(bs_models/include/bs_models/global_mapping/global_map_refinement.h:37-144):
  1. SubmapRefinement (submap_refinement.cpp:24-162) — per-submap
     re-registration of every keyframe scan against the submap map + priors →
     optimize → updated keyframe poses. Each submap becomes one fixed-shape
     window problem and the whole batch is one batched LM solve: the
     shared-topology solver when every submap has the same keyframe count,
     else the per-window solve of :mod:`beam_slam_tpu_torch.parallel.sharded`
     (one K1 launch of B systems per LM step either way).
  2. SubmapAlignment (submap_alignment.cpp) — sequentially re-register each
     submap's aggregate cloud against its predecessor and update
     T_WORLD_SUBMAP.
  3. SubmapPoseGraphOptimization — loop-closure PGO over submap poses
     (reuses the GlobalMapper pose graph).
  4. GlobalMapBatchOptimization
     (global_map_batch_optimization.h:13-89, .cpp) — whole-trajectory pose
     graph over every lidar keyframe with ScanContext loop-closure search,
     LOAM refinement, and statistical outlier rejection of loop factors.

The reference's device-mesh branches (the sharded refinement step and the
coupled distributed pose graph) stay in the JAX package: the functions here
take no ``mesh``. Everything runs on the global map's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from beam_slam_tpu_torch.core import factors as fc
from beam_slam_tpu_torch.core import lie_np as lie
from beam_slam_tpu_torch.core import window as win
from beam_slam_tpu_torch.core.window import WindowState
from beam_slam_tpu_torch.device import to_device, to_device_many, to_numpy
from beam_slam_tpu_torch.global_mapping.global_map import GlobalMap
from beam_slam_tpu_torch.global_mapping.reloc import LoamRelocRefinement
from beam_slam_tpu_torch.global_mapping.submap import stacked_blocks
from beam_slam_tpu_torch.lidar import registration as reg
from beam_slam_tpu_torch.parallel import sharded
from beam_slam_tpu_torch.solver import gauss_newton as gn


@dataclasses.dataclass
class RefinementParams:
    """global_map_refinement.json equivalents."""

    # offline refinement favors accuracy: refit correspondences every GN
    # step (the reference's *_slow matcher configs iterate correspondences
    # up to 10x; online scan-to-map uses corr_refits=2)
    scan_registration_cfg: reg.LoamRegistrationConfig = \
        reg.LoamRegistrationConfig(iterations=8, corr_refits=8,
                                   max_corr_dist=1.0)
    prior_cov: float = 1e-2         # avg-covariance priors on current poses
    registration_cov: float = 1e-4
    solver: gn.SolverOptions = gn.SolverOptions(max_iterations=10)
    max_keyframes_per_submap: int = 16

    @staticmethod
    def from_json(source, config_root=None) -> "RefinementParams":
        """global_map_refinement.json → params (submap_refinement block +
        loop_closure covariances; matcher_config supplies correspondence
        iterations/distance)."""
        from beam_slam_tpu_torch.lidar.scan_registration import _load_json
        cfg = _load_json(source, config_root)
        p = RefinementParams()
        lc = cfg.get("loop_closure", {})
        if "local_mapper_covariance" in lc:
            p.prior_cov = float(lc["local_mapper_covariance"])
        if "loop_closure_covariance" in lc:
            p.registration_cov = float(lc["loop_closure_covariance"])
        sr = cfg.get("submap_refinement", {})
        if sr.get("matcher_config"):
            m = _load_json(sr["matcher_config"], config_root)
            refits = max(int(m.get("max_correspondence_iterations", 8)), 1)
            p.scan_registration_cfg = reg.LoamRegistrationConfig(
                iterations=refits, corr_refits=refits,
                max_corr_dist=float(
                    m.get("max_correspondence_distance", 1.0)))
        return p


def _per_kf_blocks(submap):
    """Per-keyframe feature blocks in the submap frame (fixed block sizes →
    leave-one-out maps are just validity-mask edits): (edges [n,E,3],
    edges_valid [n,E], surfs [n,S,3], surfs_valid [n,S]) on the submap's
    device."""
    return stacked_blocks(submap.lidar_keyframes, submap.device)


def _submap_problem(submap, params: RefinementParams, K: int):
    """Build one submap's refinement window: states = keyframe poses (submap
    frame); factors: registration 'measurement' priors from re-registering
    each scan against the leave-one-out submap map (a scan matched against a
    map containing its own points would just snap back to itself), plus weak
    priors at the current estimates for non-converged scans."""
    n = min(len(submap.lidar_keyframes), K)
    dev = submap.device

    e_blk, ev_blk, s_blk, sv_blk = _per_kf_blocks(submap)
    w_reg = 1.0 / np.sqrt(params.registration_cov)
    w_prior = 1.0 / np.sqrt(params.prior_cov)

    q_arr = np.tile(np.array([1, 0, 0, 0], np.float32), (K, 1))
    p_arr = np.zeros((K, 3), np.float32)
    active = np.zeros(K, bool)
    prior_q = q_arr.copy()
    prior_p = p_arr.copy()
    prior_info = np.zeros((K, 6, 6), np.float32)
    prior_active = np.zeros(K, bool)

    e_map, s_map = e_blk.reshape(-1, 3), s_blk.reshape(-1, 3)
    for i in range(n):
        kf = submap.lidar_keyframes[i]
        ev_loo = ev_blk.clone()
        ev_loo[i] = False
        sv_loo = sv_blk.clone()
        sv_loo[i] = False
        q0, p0 = to_device_many((kf.q, kf.p), dev)
        res = reg.register_loam(kf.features, e_map, ev_loo.reshape(-1),
                                s_map, sv_loo.reshape(-1), q0, p0,
                                params.scan_registration_cfg)
        q_res, p_res, conv = to_numpy(res.q, res.p, res.converged)
        q_arr[i] = kf.q
        p_arr[i] = kf.p
        active[i] = True
        if bool(conv):
            # registration result as a strong absolute "measurement" prior
            prior_q[i] = q_res
            prior_p[i] = p_res
            prior_info[i] = w_reg * np.eye(6, dtype=np.float32)
        else:
            prior_q[i] = kf.q
            prior_p[i] = kf.p
            prior_info[i] = w_prior * np.eye(6, dtype=np.float32)
        prior_active[i] = True

    (q_t, p_t, act_t, slots, pact_t, pq_t, pp_t,
     pinfo_t) = to_device_many(
        (q_arr, p_arr, active, np.arange(K, dtype=np.int64)[:, None],
         prior_active, prior_q, prior_p, prior_info), dev)
    window = WindowState.zeros(K, E=1, device=dev)
    window = window.replace(imu=window.imu.replace(q=q_t, p=p_t,
                                                   active=act_t))
    prior = fc.AbsolutePoseFactors(slots=slots, active=pact_t, q0=pq_t,
                                   p0=pp_t, sqrt_info=pinfo_t)
    return window, (prior,)


def run_submap_refinement(global_map: GlobalMap,
                          params: RefinementParams = RefinementParams(),
                          n_outer: int = 2) -> float:
    """Refine every submap's keyframe poses; the per-submap window solves are
    batched. ``n_outer`` outer rounds re-linearize the correspondences (the
    leave-one-out map is rebuilt from the updated poses). Returns the summed
    final cost."""
    total = 0.0
    for _ in range(n_outer):
        total = _run_submap_refinement_once(global_map, params)
    return total


def _run_submap_refinement_once(global_map: GlobalMap,
                                params: RefinementParams) -> float:
    from beam_slam_tpu_torch.solver import batched as bsv

    submaps = [s for s in global_map.submaps if s.lidar_keyframes]
    if not submaps:
        return 0.0
    K = params.max_keyframes_per_submap
    problems = [_submap_problem(s, params, K) for s in submaps]
    windows = win.stack([p[0] for p in problems])
    families = tuple(win.stack([p[1][f] for p in problems])
                     for f in range(len(problems[0][1])))
    losses = (None,)

    # same-topology submap batches take the shared-topology batched solver;
    # mixed topologies (submaps of different keyframe counts) the per-window
    # batched solve — one K1 launch of B systems per LM step either way
    try:
        bsv.assert_shared_topology(families)
        out, diags = bsv.solve_batched_shared(windows, families, losses,
                                              params.solver)
    except ValueError:
        out, diags = sharded.solve_batched(windows, families, losses,
                                           params.solver)
    q_all, p_all, total = to_numpy(out.imu.q, out.imu.p,
                                   torch.sum(diags.final_cost))

    # write refined poses back into the submaps
    for b, sm in enumerate(submaps):
        n = min(len(sm.lidar_keyframes), K)
        for i in range(n):
            sm.lidar_keyframes[i].q = q_all[b, i].copy()
            sm.lidar_keyframes[i].p = p_all[b, i].copy()
    return float(total)


def run_submap_alignment(global_map: GlobalMap,
                         refiner: Optional[LoamRelocRefinement] = None
                         ) -> int:
    """Align each submap to its predecessor (SubmapAlignment): re-register
    aggregate clouds, update T_WORLD_SUBMAP chains. Returns the number of
    successful alignments."""
    refiner = refiner or LoamRelocRefinement()
    n_ok = 0
    for i in range(1, len(global_map.submaps)):
        prev = global_map.submaps[i - 1]
        cur = global_map.submaps[i]
        res = refiner.refine(prev, cur)
        if not res.successful:
            continue
        # T_WORLD_CUR = T_WORLD_PREV · T_PREV_CUR
        cur.q = lie.quat_mul(prev.q, res.dq).astype(np.float32)
        cur.p = (prev.p + lie.quat_rotate(prev.q, res.dp)).astype(np.float32)
        n_ok += 1
    return n_ok


def run_pose_graph_optimization(global_map: GlobalMap,
                                max_candidates: int = 3) -> int:
    """Loop-closure PGO over submap poses (SubmapPoseGraphOptimization):
    build a fresh pose graph from the submap chain, search loop closures for
    every submap, optimize, update submap poses. Returns #closures.
    ``max_candidates`` is taken and not read, as in the reference (the
    search reads ``params.max_candidates``)."""
    from beam_slam_tpu_torch.models.global_mapper import GlobalMapper
    from beam_slam_tpu_torch.solver.smoother import Transaction
    gm = GlobalMapper(global_map.params, global_map=global_map)
    txn = Transaction(stamp=0.0)
    # chain factors
    subs = global_map.submaps
    for sm in subs:
        txn.add_imu_state(sm.stamp, sm.q, sm.p, np.zeros(3))
    if subs:
        txn.add_abs_pose(subs[0].stamp, subs[0].q, subs[0].p,
                         1e3 * np.eye(6, dtype=np.float32))
    w = 1.0 / np.sqrt(global_map.params.new_submap_rel_cov)
    for i in range(1, len(subs)):
        q_pw = lie.quat_conj(subs[i - 1].q)
        dq = lie.quat_mul(q_pw, subs[i].q)
        dp = lie.quat_rotate(q_pw, subs[i].p - subs[i - 1].p)
        txn.add_relative_pose(subs[i - 1].stamp, subs[i].stamp, dq, dp,
                              w * np.eye(6, dtype=np.float32))
    n_loops = 0
    for i in range(len(subs)):
        n_loops += global_map.run_loop_closure(i, txn)
    gm.smoother.send_transaction(txn)
    gm.smoother.run_once()
    global_map.update_submap_poses(gm.smoother.get_state)
    return n_loops


@dataclasses.dataclass
class BatchOptimizationParams:
    """global_map_batch_optimization.h equivalents."""

    rel_cov: float = 1e-3            # odometry backbone factor covariance
    loop_min_separation_s: float = 5.0
    max_loop_candidates_per_kf: int = 1
    sc_max_distance: float = 0.3
    # statistical outlier rejection (:46-66): reject loop factors whose
    # residual magnitude exceeds median + k·MAD over all loop factors
    outlier_k_mad: float = 3.0
    solver: gn.SolverOptions = gn.SolverOptions(max_iterations=20)
    max_keyframes: int = 128

    @staticmethod
    def from_json(source, config_root=None) -> "BatchOptimizationParams":
        """global_map_refinement.json 'batch_optimizer' block →
        params (lc_* loop-closure gates + covariance multiplier)."""
        from beam_slam_tpu_torch.lidar.scan_registration import _load_json
        cfg = _load_json(source, config_root)
        b = cfg.get("batch_optimizer", cfg)
        p = BatchOptimizationParams()
        if "lc_scan_context_dist_thres" in b:
            p.sc_max_distance = float(b["lc_scan_context_dist_thres"])
        if "lc_max_per_query_scan" in b:
            p.max_loop_candidates_per_kf = int(b["lc_max_per_query_scan"])
        if "lc_min_traj_dist_m" in b:
            # reference gates by trajectory distance; the JAX package maps
            # it 1:1 onto separation seconds (the ~1 m/s survey speed of
            # its platforms), and the port copies that
            p.loop_min_separation_s = float(b["lc_min_traj_dist_m"])
        if "lc_cov_multiplier" in b:
            p.rel_cov = p.rel_cov * float(b["lc_cov_multiplier"])
        return p


def _scan_cloud(f):
    """Every feature of a keyframe cloud, strong and weak: (points,
    valid)."""
    return (torch.cat([f.edge_strong, f.edge_weak, f.surf_strong,
                       f.surf_weak]),
            torch.cat([f.edge_strong_valid, f.edge_weak_valid,
                       f.surf_strong_valid, f.surf_weak_valid]))


def run_batch_optimization(global_map: GlobalMap,
                           params: BatchOptimizationParams =
                           BatchOptimizationParams()) -> dict:
    """Whole-trajectory batch optimization: pose graph over every lidar
    keyframe (world frame), ScanContext loop closures with LOAM refinement
    and MAD-based outlier rejection, then write the optimized poses back
    into the submaps. The keyframes' descriptors and the database searches
    stay on the map's device; the distances come to the host in one
    copy."""
    from beam_slam_tpu_torch.global_mapping import scancontext as sc
    from beam_slam_tpu_torch.solver.smoother import (FixedLagSmoother,
                                                     SmootherConfig,
                                                     Transaction)
    dev = global_map.device

    # gather keyframes: (stamp, q_w, p_w, features, (submap_idx, kf_idx))
    kfs = []
    for si, sm in enumerate(global_map.submaps):
        for ki, kf in enumerate(sm.lidar_keyframes):
            q_w, p_w = sm.submap_to_world(kf.q, kf.p)
            kfs.append((kf.stamp, q_w, p_w, kf.features, (si, ki)))
    kfs.sort(key=lambda x: x[0])
    kfs = kfs[: params.max_keyframes]
    if len(kfs) < 3:
        return dict(keyframes=0, loops_found=0, loops_kept=0)

    smoother = FixedLagSmoother(SmootherConfig(
        lag_duration=1e12, max_states=params.max_keyframes,
        max_rel_pose_factors=4 * params.max_keyframes,
        max_abs_pose_factors=4, max_imu_factors=2, max_prior_factors=2,
        max_landmarks=1, max_reprojection_factors=1, max_idp_factors=1,
        solver=params.solver), device=dev)
    txn = Transaction(stamp=0.0)
    w_rel = 1.0 / np.sqrt(params.rel_cov)
    for (t, q_w, p_w, _, _) in kfs:
        txn.add_imu_state(t, q_w, p_w, np.zeros(3))
    txn.add_abs_pose(kfs[0][0], kfs[0][1], kfs[0][2],
                     1e3 * np.eye(6, dtype=np.float32))
    for i in range(1, len(kfs)):
        q_i = kfs[i - 1][1]
        dq = lie.quat_mul(lie.quat_conj(q_i), kfs[i][1])
        dp = lie.quat_rotate(lie.quat_conj(q_i), kfs[i][2] - kfs[i - 1][2])
        txn.add_relative_pose(kfs[i - 1][0], kfs[i][0], dq, dp,
                              w_rel * np.eye(6, dtype=np.float32))

    # ScanContext descriptors per keyframe (scan frame), and every
    # keyframe's search of the database
    cfg_sc = sc.ScanContextConfig()
    descs = torch.stack([sc.make_descriptor(*_scan_cloud(k[3]), cfg_sc)
                         for k in kfs])
    stamps = np.asarray([k[0] for k in kfs])
    valid_db = np.abs(stamps[:, None] - stamps[None, :]) \
        > params.loop_min_separation_s
    valid_t = to_device(valid_db, dev)
    dists_all = to_numpy(torch.stack([
        sc.search(descs[i], descs, valid_t[i])[0]
        for i in range(len(kfs))]))[0]

    # loop candidates + LOAM refinement
    loops = []
    loop_cfg = reg.LoamRegistrationConfig(iterations=10, corr_refits=10,
                                          max_corr_dist=2.0)
    for i, (t_i, q_i, p_i, fc_i, _) in enumerate(kfs):
        if not valid_db[i].any():
            continue
        dists = dists_all[i]
        order = np.argsort(dists)
        for j in order[: params.max_loop_candidates_per_kf]:
            if float(dists[j]) > params.sc_max_distance or j <= i:
                continue
            t_j, q_j, p_j, fc_j, _ = kfs[j]
            # register keyframe j against keyframe i's features
            me = torch.cat([fc_i.edge_strong, fc_i.edge_weak])
            mev = torch.cat([fc_i.edge_strong_valid, fc_i.edge_weak_valid])
            ms = torch.cat([fc_i.surf_strong, fc_i.surf_weak])
            msv = torch.cat([fc_i.surf_strong_valid, fc_i.surf_weak_valid])
            # seed: relative pose from current estimates, in frame i
            q_ii = lie.quat_conj(q_i)
            dq0 = lie.quat_mul(q_ii, q_j)
            dp0 = lie.quat_rotate(q_ii, p_j - p_i)
            res = reg.register_loam(fc_j, me, mev, ms, msv,
                                    *to_device_many((dq0, dp0), dev),
                                    loop_cfg)
            q_res, p_res, conv = to_numpy(res.q, res.p, res.converged)
            if not bool(conv):
                continue
            loops.append((t_i, t_j, q_res, p_res, dq0, dp0))

    # statistical outlier rejection on loop residuals vs current estimates
    kept = []
    if loops:
        resid = np.asarray([float(np.linalg.norm(dp_meas - dp0))
                            for (_, _, _, dp_meas, _, dp0) in loops])
        med = np.median(resid)
        mad = np.median(np.abs(resid - med)) + 1e-6
        for loop, r in zip(loops, resid):
            if r <= med + params.outlier_k_mad * mad:
                kept.append(loop)
    w_loop = 1.0 / np.sqrt(1e-4)
    for (t_i, t_j, dq_m, dp_m, _, _) in kept:
        txn.add_relative_pose(t_i, t_j, dq_m, dp_m,
                              w_loop * np.eye(6, dtype=np.float32))

    smoother.send_transaction(txn)
    smoother.run_once()
    poses = {t: smoother.get_state(t) for (t, *_r) in kfs}

    # write back: world keyframe poses → submap-frame keyframe poses
    for (t, _, _, _, (si, ki)) in kfs:
        st = poses[t]
        sm = global_map.submaps[si]
        q_sb, p_sb = sm.world_to_submap(st["q"], st["p"])
        sm.lidar_keyframes[ki].q = np.asarray(q_sb, np.float32)
        sm.lidar_keyframes[ki].p = np.asarray(p_sb, np.float32)
    return dict(keyframes=len(kfs), loops_found=len(loops),
                loops_kept=len(kept))


def run_full_refinement(global_map: GlobalMap,
                        params: RefinementParams = RefinementParams()
                        ) -> dict:
    """The GlobalMapRefinement orchestrator (global_map_refinement.cpp):
    submap refinement → submap alignment → pose-graph optimization →
    batch optimization."""
    cost = run_submap_refinement(global_map, params)
    n_aligned = run_submap_alignment(global_map)
    n_loops = run_pose_graph_optimization(global_map)
    batch = run_batch_optimization(global_map)
    return dict(refinement_cost=cost, submaps_aligned=n_aligned,
                loop_closures=n_loops, **{f"batch_{k}": v
                                          for k, v in batch.items()})
