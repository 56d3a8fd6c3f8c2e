#!/usr/bin/env python3
"""Smoke run of the PyTorch port (beam_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # everything below
    python3 chip_smoke.py k1     # build, then K1's checks and times only
    python3 chip_smoke.py k2     # build, then K2's checks and times only, on
                                 # the LIO map built at ground-truth poses
    python3 chip_smoke.py k3     # the same for K3
    python3 chip_smoke.py smoother
                                 # build K1 and K2, then only the LIO+IMU
                                 # session of the fixed-lag smoother
    python3 chip_smoke.py mapper # build K1 and K2, then only the LIO
                                 # LocalMapper session (phase 11)
    python3 chip_smoke.py lvio   # build K1 and K2, then only phase 12: the
                                 # LVIO and VIO LocalMappers and the image
                                 # front end
    python3 chip_smoke.py global # build K1 and K2, then only phase 13:
                                 # global mapping and the map refinement
    python3 chip_smoke.py localization
                                 # build K1 and K2, run 13a's global
                                 # mapper, then only phase 14 on its map:
                                 # MultiScan and the LidarTracker
    python3 chip_smoke.py completion
                                 # build K1 and K2, then only phase 15: the
                                 # last modules of the port
    python3 chip_smoke.py ate [seconds]
                                 # build K1 and K2, then the ATE runner's
                                 # LIO, VIO and LVIO sessions (default 60 s
                                 # each), three processes at once; fails if
                                 # a mode's ATE is not under 0.05 m
    python3 chip_smoke.py ate-one MODE SECONDS cuda|cpu
                                 # one runner session (phase 16's side
                                 # process), its JSON line
    python3 chip_smoke.py knn-counts [cpu|cuda]
                                 # K2's schedule (its mirror) at the LIO
                                 # shapes: the insertions each warp runs

Builds the port's three hand-written CUDA kernels with nvcc for sm_90a, one
nvcc process each, all started together: K1 (batched Cholesky factor+solve:
a thread-block cluster per system, csrc/cholesky.cu, or for few large
systems the whole card, csrc/cholesky_grid.cu), K2 (exact kNN top-k,
csrc/knn.cu) and K3 (fixed-radius neighbourhood moments, csrc/moments.cu).
K1 is held against its plain version over shapes from 1×1 to 64 systems of
640², every cluster size, a NaN-poisoned upper triangle, bad pivots and a
bit-equal repeat; both schedules, forced and by the rule, from 1024² to
6001², the grid's own NaN, bad-pivot and repeat checks; and timed against
the library pair. Then it drives the port's paths and holds every kernel
against its plain PyTorch version on the card:

  * the flagship LVIO solve — one Levenberg–Marquardt bundle-adjustment
    solve of a 40-state window (39 IMU, 39 lidar relative-pose, 2048
    reprojection and 448 inverse-depth factors, 320 Schur-eliminated
    landmarks; a 640×640 reduced system) and the shared-topology batched
    solve of 8 such windows (K1);
  * the LIO front end at full width — the vendored VLP-16 scan
    (tests/data/test_scan_vlp16.pcd.gz) organised at 16 × 1800 and seen
    from 12 poses along a path, registered scan to map through
    create_scan_registration on configs/ (registration/scan_to_map.json +
    matchers/loam_vlp16.json: a 10-scan map deduped on a 0.1 m voxel grid,
    8 GN steps with adaptive refits), checked against ground truth and
    against the CPU plain path (K2); the pipelined device-map strategy on
    the same scans; and one radius-mode registration (K3);
  * an LIO+IMU session of the fixed-lag smoother at configs/lio.yaml's
    capacities (64 states, lag 4 s, LM up to 40 steps with early exit, the
    sync tick): the scan seen along an analytic trajectory, registered every
    0.25 s keyframe from the IMU's predicted pose (K2), with the
    preintegrated IMU factor of a 200 Hz stream and a gravity factor; every
    LM step solves the 1024² reduced system with K1. Checked against
    ground truth, the window bound, marginalization, costs, K1 on that
    system and one tick against the CPU plain path;
  * the LIO LocalMapper, the system's entry point, of
    LocalMapperConfig.from_yaml("configs/lio.yaml") with the default async
    tick (each solve on a worker thread and a side stream, harvested on the
    next tick): 10 s of pipeline/sim_session's events, the vendored scan
    seen from every scan's pose, through SLAM initialization (LIDAR mode:
    registrations with K2, inertial alignment, the ignition solve with K1),
    lidar odometry (the JSON tier's scan-to-map strategy, its crop boxes),
    gravity alignment and inertial odometry. Checked against ground truth
    (window after the flush, the ATE of each solve's newest state), the
    transaction counters, every solve's costs, K1 on the mapper's system
    and its last problem against the CPU plain path; timed per tick
    (ingestion, tick, the worker's solve and its overlap with ingestion);
  * the LVIO LocalMapper of configs/lvio.yaml at its full width (64 states,
    lag 10 s, LM up to 10 steps, 256 landmarks, 4096 reprojection factors,
    the LVIO information-weight tier, the pipelined scan-to-map strategy on
    the device map, initialization at 3.5 m, the async tick): sim_session's
    LVIO events (200 Hz IMU, 20 Hz camera, 10 Hz lidar, its structured
    16 × 504 scene) through SLAM initialization, lidar and visual odometry,
    gravity alignment and inertial odometry, with the same checks as the
    LIO mapper plus the visual map's; the feature tracker of its vo/ JSON
    tier card vs CPU on a moving 640 × 480 texture; and the VIO LocalMapper
    of configs/vio.yaml, its ignition from the camera's SfM path;
  * global mapping: the GlobalMapper of configs/global_map/global_map.json
    at its default graph capacities (128 states: K1 at N = 2048 every LM
    step) fed 61 SlamChunks around a loop in a hall (each scan ray-cast
    at 16 × 1800 from the true pose, odometry drifting to 0.5 m and 2°),
    closing the loop and answering a reloc
    request; then run_full_refinement of that map (submap refinement as
    one batched solve of B windows of 256² (K1), alignment, the pose-graph
    and batch optimizations; K2 in every registration) and the refinement
    CLI's alignment stage on the saved map. Checked against the truth, the reference test's
    criteria, K1 at (1, 2048) and (B, 256) against its plain version, the
    graph's last problem, a refinement batch and a submap registration card
    vs CPU; K1 and K2 timed at the phase's shapes;
  * localization: MultiScan registration (configs/registration/
    multi_scan.json) with each matcher of configs/matchers/ (LOAM, ICP,
    GICP, NDT) on hall scans at 16 × 1800, held against the truth and the
    CPU plain path, K2 at ICP's and GICP's shapes; then a LidarTracker on
    the first submap of the global mapper's map (its ActiveSubmap), with
    configs/lio.yaml's smoother (K1 at N = 1024) and the scan-to-map
    strategy, its reloc requests answered by the GlobalMapper, each scan
    also through the feature extractor, the deskewer and the aggregation
    model card vs CPU. Phase 11 writes its IMU samples and scans to a
    sensor log and runs on what it reads back (the native index);
  * the last modules of the port (phase 15): the coupled whole-trajectory
    pose graph at 1000 keyframes (D = 6000) over 8 factor shards, over a
    2 × 4 hosts × shards layout and over one, every LM step's damped
    system through K1 at (1, 6000), held against the reference test's
    bounds and the CPU plain path, K1 timed there by CUDA events and by
    the port's amortized timer; the flagship BA over 8 factor shards
    against phase 4's solve; the unary inverse-depth problem card vs CPU;
    the sharded refinement step over phase 5's windows; the threaded
    mapper in lockstep on phase 11's events (its publishers and
    diagnostics) and free-running on the JAX test's session; binary
    descriptors and the image database card vs CPU; the calibration
    viewer;
  * the ATE runner (beam_slam_tpu_torch/tools/run_ate_benchmark.py, phase
    16): its LIO, VIO and LVIO sessions (lag 4 / 7 / 10 s, 64 / 64 / 128
    states: K1 at (1, 1024) and (1, 2048), K2 in every registration) under
    its sync oracle, 6 s each as the JAX package's always-on envelope
    smoke, held to that smoke's bounds (ATE < 0.05 m; LIO more than 20
    solves), and the LIO session on the CPU beside the card's, every
    solve's newest state within 2e-3 m / 2e-3 rad.

Phases print one line each; any failure raises and exits non-zero. In
the whole run phase 12 runs in a second process (``chip_smoke.py lvio``)
and phase 16 in four more (``chip_smoke.py ate-one``) beside phases 10
and 11, on the same card; their lines are printed, indented, when they
have ended, before phase 13 starts. The
line before the last two is the kernels' JSON record, then the card's name
and power limit, and the last line the run's JSON verdict. Requires CUDA:
without a card it fails and prints no result.
"""

import collections
import dataclasses
import gzip
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

LOSSES = (None, None, 1.0, 2.0, 2.0)
CENSUS = dict(n_kf=40, kf_dt=0.25, with_vision=True, n_landmarks=256,
              obs_per_lm=8, n_idp=64)
BATCH = 8
# K1 vs plain: the bound the reference's own kernel test uses
# (tests/test_pallas_cholesky.py), and a residual bound.
X_TOL, RES_TOL = 2e-3, 1e-2
# Flagship solve, card vs CPU plain path: same math, float32 sums in another
# order and atomics in the scatter assembly. Final cost relative gap, and the
# largest gap of any state position in metres (the CPU parity test's bound).
COST_RTOL, DP_TOL = 1e-5, 5e-4

# LIO front end at full width: the vendored scan, the repo's production
# configs (configs/lio.yaml names this pair), 12 poses along a path.
ROOT = Path(__file__).resolve().parent
SCAN_GZ = ROOT / "tests" / "data" / "test_scan_vlp16.pcd.gz"
N_RINGS, WIDTH = 16, 1800           # as tests/test_real_scan.py:41-42
LIO_JSON = ("registration/scan_to_map.json", "matchers/loam_vlp16.json")
LIO_SCANS = 12
LIO_SEED = 7                        # numpy RNG of the seed perturbations
SEED_ROT, SEED_TRANS = 0.02, 0.1    # perturbation std, as test_real_scan.py
GT_TRANS, GT_ROT = 0.05, 0.02       # tests/test_real_scan.py:135-138
CARD_CPU_DP, CARD_CPU_ROT = 2e-3, 2e-3  # one registration, card vs CPU
PIPE_TOL = 2e-3                     # tests/test_pipelined_registration.py
RADIUS_GT = 0.02                    # tests/test_lidar.py:194-196
# K2 vs plain: distances rtol 1e-5 / atol 1e-5·max‖q‖²; neighbour sets equal
# (up to swaps between distances equal within that) for ≥ 99.5% of queries.
KNN_RTOL, KNN_SET_FRAC = 1e-5, 0.995
# K3 vs plain: n exact, except at ≤ 0.1% of queries, and there only by refs
# whose float64 distance lies within 1e-6·(‖q‖² + ‖r‖²) of rad² (the
# kernel's fused q·r and the matmul's round differently); at the others the
# centroid within 1e-5·(‖q‖ + rad) + 1e-6 and the scatter within
# 4e-6·n·(‖q‖ + rad)² + 1e-5 — fp32 sums of n terms of size ‖r‖² in
# another order, then the cancellation S = m2 − n·c cᵀ.
MOM_DIFF_FRAC, MOM_EDGE_RTOL = 1e-3, 1e-6
# Published H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores.
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
KNN_LIB_BLOCK = 16384   # queries per cdist + topk call of the yardstick


# The LIO+IMU session (phase 10) at configs/lio.yaml's capacities: the
# smoother configuration of LocalMapperConfig.from_yaml("configs/lio.yaml")
# with one reduction, the sync tick (async_solve=False); phase 11 runs the
# whole mapper with the async tick.
LIO_YAML = "lio.yaml"
# GravityAlignment as LocalMapper wires it (pipeline/local_mapper.py: the
# config's gravity_info_weight, 10 from configs/lio.yaml's information
# weights tier; a 201-sample window; a 0.05 s gate)
LIO_GRAVITY = dict(info_weight=10.0, smooth_window=201, max_imu_dt=0.05)
SESSION_KF_DT, SESSION_S, IMU_RATE = 0.25, 4.5, 200.0  # 19 keyframes
SESSION_SEED = 11                   # torch.Generator of the IMU noise
SESSION_IMU_SIGMA = (2e-3, 2e-2)    # gyro rad/s, accel m/s² per sample
# Phase 11, the LIO LocalMapper: 10 s of pipeline/sim_session's events
# (its analytic trajectory, 200 Hz IMU, 10 Hz lidar, seed 11), every scan
# the vendored one seen from that scan's lidar pose.
MAPPER_S, MAPPER_LIDAR_HZ, MAPPER_SEED = 10.0, 10.0, 11
# The last ticks (phase 10) and frames (phases 11, 12a) run under the
# profiler. One each: turning the profiler's events into the idle share
# costs ~2 ms of host time per device op while the host's ops are traced
# too, and three ticks at the LM step cap held ~180K of them (~6 minutes
# of the script's wall). Phases 10 and 13 trace the card's activity only
# (_busy_ms); the mappers' frames trace both, as before: tracing the host
# changes the async tick's timing, hence which problem a mapper dispatches
# last, which phases 11 and 12 hold card vs CPU.
SESSION_PROFILED = MAPPER_PROFILED = 1
MAPPER_YAML = {"LIO": LIO_YAML, "LVIO": "lvio.yaml", "VIO": "vio.yaml"}
# Phase 12: the LVIO mapper (12a) at lvio.yaml's full width and the VIO
# mapper (12c) with VISUAL initialization, the camera at 20 Hz; the image
# front end (12b) on a seeded 640 × 480 texture moving 0.35 / -0.65 px a
# frame, its tracks card vs CPU within FRONT_END_PX.
LVIO_S, VIO_S, CAM_HZ = 14.0, 4.0, 20.0
# 12c ignites after 1.0 m of SfM path, not vio.yaml's 3.0 m: until it
# ignites, VISUAL initialization reruns the SfM path and the inertial
# alignment on every camera frame, ~5 s a frame on the card, and at 3.0 m
# (6.65 s of these events) that took 650.8 s of the phase's 658.5 s.
VIO_INIT_M = 1.0
# 12a's lidar sees the session's own structured 16 × 504 scene: on the
# vendored scan the LVIO mapper of lvio.yaml leaves ground truth in the JAX
# package as in the port (tests/test_torch_lvio_vendored.py; ROADMAP
# Queue 3).
FRONT_END_SEED, FRONT_END_FRAMES, FRONT_END_STEP = 13, 10, (0.35, -0.65)
FRONT_END_PX = 1e-3
# Phase 13, global mapping: the GlobalMapper of configs/global_map/
# global_map.json (10 m submaps; its inline EUCDIST search reads
# distance_threshold_m, so the gate is the 10 m default, as in the JAX
# package) at its default graph capacities (128 states, 512 relative poses,
# LM <= 15 steps: a 2048² reduced system), fed a SlamChunk every metre
# around a 20 m × 8 m rectangle in the HALL below, first corner at
# GLOBAL_ORIGIN, counter-clockwise with the yaw along each side, and
# GLOBAL_EXTRA metres past the start: 61 chunks in 5 submaps, the last
# overlapping the first (with a 10 m short side the last submap's origin
# lay on the search's 10 m gate: no loop closed). Every chunk's features
# are a scan ray-cast from the true pose at 16 × 1800; its pose is the
# truth moved by a rigid drift that grows linearly to GLOBAL_DRIFT (m of
# shift, degrees of yaw about the first pose; its direction from numpy seed
# GLOBAL_SEED). Then the offline refinement of that map and the CLI on it.
GLOBAL_JSON = "global_map/global_map.json"
GLOBAL_RECT, GLOBAL_ORIGIN, GLOBAL_EXTRA = (20.0, 8.0), (-10.0, -4.0), 4
GLOBAL_SEED, GLOBAL_DRIFT = 13, (0.5, 2.0)
RELOC_OFF, RELOC_TOL = (0.5, 3.0), (0.1, 0.02)   # m, degrees; m, rad
# Phase 14, localization. 14a: MultiScan registration (configs/registration/
# multi_scan.json: 3 neighbours) with each matcher of configs/matchers/ on
# phase 13's hall at 16 × 1800, MULTISCAN_SCANS poses ~0.3 m apart (numpy
# seed MULTISCAN_SEED perturbs the seeds as phase 6 does); every factor
# within the JAX tests' bounds for that matcher (m, rad): LOAM phase 6's,
# ICP and GICP tests/test_registration_factory.py:93-97, NDT
# tests/test_matchers.py:38-53. 14b: a LidarTracker on the first submap of
# 13a's map (its ActiveSubmap), lio.yaml's smoother (K1 at (1, 1024)) and
# the configs/ scan-to-map strategy, fed LOCALIZE_SCANS hall scans 0.5 m
# apart on a second pass along the first side, off the keyframes, reloc
# requests answered by the GlobalMapper; card vs CPU within LOCAL_CPU_TOL
# m for the feature extractor's, deskewer's and aggregation's points.
MULTISCAN_JSON = "registration/multi_scan.json"
MULTISCAN_MATCHERS = {"loam_vlp16": (0.05, 0.02), "icp": (0.1, 0.05),
                      "gicp": (0.1, 0.05), "ndt": (0.15, 0.02)}
MULTISCAN_SCANS, MULTISCAN_SEED = 6, 17
# ICP and NDT miss those bounds on these scans in the JAX package as in the
# port (ICP 0.177 m, NDT 0.168 m / 0.028 rad; ROADMAP Queue 3): their
# factors are held instead to the JAX package's CPU factors, which
# tests/test_torch_multiscan_hall.py writes to this file and checks, within
# the registration agreement bounds (CARD_CPU_DP, CARD_CPU_ROT).
MULTISCAN_JAX = ROOT / "tests" / "data" / "multiscan_hall_jax.json"
LOCALIZE_SCANS, LOCALIZE_SEED, LOCALIZE_DT = 8, 19, 0.5
LOCAL_CPU_TOL = 1e-5
# Phase 12c solves the VIO mapper's last dispatched problem to convergence
# (phase 11's cap of 40 LM steps with early exit). Two float32 solves of it
# end at different points of a flat valley, whose costs differ by about
# COST_RTOL even under one exact evaluator, so the card is held step by
# step instead: every LM step of the card's solve is also taken on the CPU
# plain path from the same state and λ, and both trial states are costed
# by the CPU plain path in float64 (_lockstep_card_vs_cpu).
SOLVED_LM_STEPS = 40


def lio_smoother_config():
    """The port's SmootherConfig for configs/lio.yaml (LIO mode): lag 4 s,
    period 0.04 s, pseudo-marginalization, 64 states, the other arenas at
    their defaults, vision arenas at 1, Cauchy 1.0 on relative poses, LM
    capped at 40 steps with early exit at function tolerance 1e-6 — with
    the sync tick."""
    from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
    cfg = LocalMapperConfig.from_yaml(str(ROOT / "configs" / LIO_YAML))
    return dataclasses.replace(cfg.smoother_config(), async_solve=False)


def _spd(gen, B, N, cond=1e3):
    A = torch.randn(B, N, N, generator=gen)
    H = A @ A.transpose(1, 2) / N + torch.eye(N) / cond
    return H.cuda().contiguous(), torch.randn(B, N, generator=gen).cuda()


def _spd_card(seed, B, N, cond=1e3):
    """_spd's systems made on the card from a seeded CUDA generator: an
    A·Aᵀ of N = 6000 takes seconds on the host."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, N, N, generator=gen, device="cuda")
    H = A @ A.transpose(1, 2) / N + torch.eye(N, device="cuda") / cond
    return H.contiguous(), torch.randn(B, N, generator=gen, device="cuda")


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _paired_ms(kernel, plain, reps=20):
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    p1 = _event_ms(plain, reps)
    k1 = _event_ms(kernel, reps)
    k2 = _event_ms(kernel, reps)
    p2 = _event_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _device_ms(fn, name, reps=20):
    """Mean time on the card's own clock (profiler) of the kernels whose
    name holds ``name``, over ``reps`` calls of ``fn``: what the kernel
    takes, where back-to-back calls may be paced by the host instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then loses most of a window's events: take the
    # fullest of three windows, and the mean of the launches it saw
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        best = max(best, us, key=len)
        if len(best) == reps:
            break
    if not (best and sum(best) > 0):
        raise RuntimeError(f"the profiler saw no launch of {name}")
    return sum(best) / len(best) / 1e3


def _wall_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _bound(nbytes, ops):
    """Least time for the work on the card: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _knn_bound(Q, R, n_valid, k):
    # each (query, valid ref) pair: 3 products + 2 sums (q·r), ×2, 2 sums,
    # compare; an invalid ref needs no operation
    return _bound(Q * 12 + R * 13 + Q * k * 12, 9 * Q * n_valid)


def _moments_bound(Q, R, n_valid, n_neighbours):
    # 9 per (query, valid ref) pair for distance and test, 16 per neighbour
    # for the moments; an invalid ref needs no operation
    return _bound(Q * 12 + R * 13 + Q * 52,
                  9 * Q * n_valid + 16 * n_neighbours)


def _chol_bound(B, N):
    return _bound(B * (N * N + 2 * N + 1) * 4, B * (N ** 3 / 3 + 2 * N * N))


def _knn_check(knn, q, r, v, k, label, cluster=None):
    """K2 vs its plain version on the card; returns max |Δd2| (finite)."""
    idx, d2 = knn.knn_topk(q, r, v, k, cluster=cluster)
    idx_p, d2_p = knn.knn_topk_reference(q, r, v, k)
    torch.cuda.synchronize()
    idx, d2, idx_p, d2_p = (t.cpu().numpy() for t in (idx, d2, idx_p, d2_p))
    qn = q.cpu().numpy()
    atol = KNN_RTOL * float((qn * qn).sum(1).max())
    fin = np.isfinite(d2_p)
    if not np.array_equal(np.isfinite(d2), fin):
        raise RuntimeError(f"K2 {label}: +inf slots differ")
    err = float(np.abs(d2[fin] - d2_p[fin]).max()) if fin.any() else 0.0
    if not np.allclose(d2[fin], d2_p[fin], rtol=KNN_RTOL, atol=atol):
        raise RuntimeError(f"K2 {label}: distances differ by {err}")
    if idx.min() < 0 or idx.max() >= r.shape[0]:
        raise RuntimeError(f"K2 {label}: index out of range")
    same = 0
    for n in range(len(qn)):
        f = fin[n]
        a, b = set(idx[n][f].tolist()), set(idx_p[n][f].tolist())
        if a == b:
            same += 1
            continue
        kth = float(d2_p[n][f].max())
        swapped = [float(d2[n][idx[n] == i][0]) if i in a
                   else float(d2_p[n][idx_p[n] == i][0]) for i in a ^ b]
        same += all(abs(d - kth) <= atol + KNN_RTOL * abs(kth)
                    for d in swapped)
    frac = same / max(len(qn), 1)
    if frac < KNN_SET_FRAC:
        raise RuntimeError(f"K2 {label}: neighbour sets agree for "
                           f"{frac:.4f} of queries")
    at = "" if cluster is None else f" S={cluster}"
    print(f"[7] K2 {label} Q={q.shape[0]} R={r.shape[0]} k={k}{at}: "
          f"max|d2-d2_plain|={err:.3e} (atol {atol:.3e}), sets agree for "
          f"{frac:.4f}", flush=True)
    return err


def _grid_points(gen, n, span=6):
    """Points with small integer coordinates: every distance is exact in
    float32, whatever the order of the sums, and many are equal."""
    return torch.randint(-span, span + 1, (n, 3), generator=gen).float()


def knn_checks(inputs, card=""):
    """K2 on the card: against its plain version at the LIO path's two
    shapes (``inputs``, as ``lio_knn_inputs`` gives them) at the chosen and
    at every cluster size, and at edge shapes; its indices equal to its
    mirror's on duplicated refs; bit-equal repeats; then the times of both
    LIO shapes against the plain version and ``cdist`` + ``topk``."""
    from beam_slam_tpu_torch.ops import knn
    dev = torch.cuda.current_device()
    slots = knn.cluster_slots(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = [S for S in knn.CLUSTER_SIZES if slots[S] >= 1]
    chosen = {label: knn.choose_cluster_size(q.shape[0], slots, n_sms)
              for q, _, _, _, label in inputs}
    print(f"[7] K2 clusters: of S CTAs, the card holds at once {slots}; "
          f"chosen S {chosen}", flush=True)
    err = 0.0
    for q, r, v, k, label in inputs:
        err = max(err, _knn_check(knn, q, r, v, k, label))
        for S in sizes:
            err = max(err, _knn_check(knn, q, r, v, k, label, cluster=S))
    gen = torch.Generator().manual_seed(3)
    rq = (torch.rand(1000, 3, generator=gen) * 20 - 10).cuda()
    rr = (torch.rand(3001, 3, generator=gen) * 20 - 10).cuda()
    rv = (torch.rand(3001, generator=gen) < 0.7).cuda()
    few = torch.zeros(64, dtype=torch.bool)
    few[[3, 17, 40]] = True
    few = few.cuda()
    none = torch.zeros(64, dtype=torch.bool).cuda()
    err = max(err, _knn_check(knn, rq, rr, rv, 8, "ragged"),
              _knn_check(knn, rq[:33], rr, rv, 5,
                         "one query in the last tile"),
              _knn_check(knn, rq[:100], rr[:64], few, 10, "3 valid of 64"),
              _knn_check(knn, rq[:100], rr[:64], none, 5, "no valid ref"))
    for S in sizes:  # R < S·W·T: most warps hold no ref, all reach the merge
        err = max(err, _knn_check(knn, rq, rr[:100], rv[:100], 10,
                                  "R=100", cluster=S))
    # duplicated refs on an integer grid: exact distances, many equal, each
    # point twice at two indices; the result is the (d², index) order
    base = _grid_points(gen, 700)
    dup = torch.cat([base, base[torch.randperm(700, generator=gen)]])
    dq = _grid_points(gen, 333).cuda()
    dup = dup.cuda()
    dv = (torch.rand(1400, generator=gen) < 0.9).cuda()
    for k in knn.KS:
        for S in sizes:
            idx, d2 = knn.knn_topk(dq, dup, dv, k, cluster=S)
            idx_m, d2_m = knn.knn_topk_split_mirror(dq, dup, dv, k, cluster=S)
            if not (torch.equal(idx, idx_m) and torch.equal(d2, d2_m)):
                raise RuntimeError(f"K2 duplicated refs k={k} S={S}: the "
                                   f"kernel's result is not its mirror's")
        err = max(err, _knn_check(knn, dq, dup, dv, k, "duplicated refs"))
    print(f"[7] K2 duplicated refs (333, 1400): indices and d² equal to the "
          f"mirror's exactly at k = {list(knn.KS)} and S = {sizes}",
          flush=True)
    for q, r, v, k, label in inputs:
        runs = [knn.knn_topk(q, r, v, k) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise RuntimeError(f"K2 {label}: two launches differ")
    print("[7] K2 at both LIO shapes: two launches give bit-equal results",
          flush=True)

    times = {}
    for q, r, v, k, label in inputs:
        Q, R, n_valid = q.shape[0], r.shape[0], int(v.sum())
        k_ms, k_plain = _paired_ms(lambda: knn.knn_topk(q, r, v, k),
                                   lambda: knn.knn_topk_reference(q, r, v, k))
        # the library yardstick on the same inputs: invalid refs masked to
        # +inf (it ranks distances, not their squares: the same order)
        k_lib = _event_ms(lambda: torch.topk(
            torch.cdist(q, r).masked_fill_(~v, float("inf")), k,
            largest=False), 20)
        dev_ms = _device_ms(lambda: knn.knn_topk(q, r, v, k),
                            "knn_topk_kernel")
        per_s = {S: round(_device_ms(
            lambda: knn.knn_topk(q, r, v, k, cluster=S), "knn_topk_kernel"),
            4) for S in sizes}
        # the same scan with shorter or longer lists: what insertions cost
        per_k = {kk: round(_device_ms(lambda: knn.knn_topk(q, r, v, kk),
                                      "knn_topk_kernel"), 4)
                 for kk in knn.KS}
        bound = _knn_bound(Q, R, n_valid, k)
        times[label] = dict(ms=dev_ms, call_ms=k_ms, plain=k_plain,
                            lib=k_lib, bound=bound)
        print(f"[7] K2 {label} ({Q}, {R}, k={k}), {n_valid} valid refs: "
              f"kernel {dev_ms:.4f} ms on the device at S={chosen[label]} "
              f"(profiler), {k_ms:.4f} ms a call back to back (CUDA "
              f"events); plain {k_plain:.3f} ms, cdist+topk {k_lib:.3f} ms "
              f"(CUDA events); bound {bound[0]:.4f} ms ({bound[1]}); kernel "
              f"device ms by cluster size {per_s}, by k {per_k} ({card})",
              flush=True)
    return dict(err=err, times=times)


def _moments_check(moments, q, r, v, rad, label, cluster=None):
    """K3 vs its plain version on the card; returns (max |Δ| over c and S,
    neighbours found)."""
    mom = moments.raw_moments(q, r, v, rad, cluster=cluster)
    mom_p = moments.raw_moments_reference(q, r, v, rad)
    n, c, S = (t.cpu().numpy() for t in moments.finish(mom))
    n_p, c_p, S_p = (t.cpu().numpy() for t in moments.finish(mom_p))
    qn = q.cpu().numpy().astype(np.float64)
    same = n == n_p
    if (~same).sum() > MOM_DIFF_FRAC * len(n):
        raise RuntimeError(f"K3 {label}: counts differ at "
                           f"{int((~same).sum())} queries")
    # a count may differ only by refs whose exact distance lies within fp32
    # rounding of the radius: the two sides round q·r differently
    rn = r.cpu().numpy().astype(np.float64)[v.cpu().numpy()]
    rr = (rn * rn).sum(1)
    for i in np.flatnonzero(~same):
        qq = float(qn[i] @ qn[i])
        d2 = ((rn - qn[i]) ** 2).sum(1)
        edge = np.abs(d2 - rad * rad) <= MOM_EDGE_RTOL * (qq + rr)
        if abs(n[i] - n_p[i]) > edge.sum():
            raise RuntimeError(f"K3 {label}: query {i} counts {n[i]} vs "
                               f"{n_p[i]}, {int(edge.sum())} refs on the "
                               f"radius")
    scale = np.linalg.norm(qn, axis=1) + rad
    c_err = np.abs(c - c_p).max(1)[same]
    S_err = np.abs(S - S_p).reshape(len(n), 9).max(1)[same]
    c_ok = c_err <= 1e-5 * scale[same] + 1e-6
    S_ok = S_err <= 4e-6 * n[same] * scale[same] ** 2 + 1e-5
    if not (c_ok.all() and S_ok.all()):
        raise RuntimeError(f"K3 {label}: centroid/scatter out of bounds at "
                           f"{int((~c_ok).sum())}/{int((~S_ok).sum())} "
                           f"queries")
    err = float(max(c_err.max(initial=0.0), S_err.max(initial=0.0)))
    at = "" if cluster is None else f" S={cluster}"
    print(f"[7] K3 {label} Q={q.shape[0]} R={r.shape[0]} rad={rad}{at}: n "
          f"exact at {int(same.sum())} of {len(n)} queries, the rest only by "
          f"refs on the radius ({int(n.sum())} neighbours), "
          f"max|Δc|={c_err.max(initial=0.0):.3e}, "
          f"max|ΔS|={S_err.max(initial=0.0):.3e}", flush=True)
    return err, int(n.sum())


def _chol_compare(chol, H, g, label, H_kernel=None, **knobs):
    """K1 against its plain version on one batch of SPD systems; returns
    max |x − x_plain|. ``H_kernel`` is what the kernel is given instead of H
    (the same lower triangle); ``knobs``: the wrapper's measurement knobs
    (cluster, schedule)."""
    x, info = chol.cholesky_solve_batched(
        H if H_kernel is None else H_kernel, g, **knobs)
    x_ref, info_ref = chol.cholesky_solve_batched_reference(H, g)
    torch.cuda.synchronize()
    B, N = g.shape
    err = float((x - x_ref).abs().max())
    scale = float(x_ref.abs().max())
    Hs = torch.tril(H) + torch.tril(H, -1).transpose(1, 2)
    res = float((torch.einsum("bij,bj->bi", Hs, x) - g).abs().max())
    ok = (err <= X_TOL * scale and res <= RES_TOL * float(g.abs().max())
          and int(info.abs().sum()) == 0 and int(info_ref.abs().sum()) == 0)
    print(f"[3] K1 B={B} N={N}{label}: max|x-x_ref|={err:.3e} "
          f"(bound {X_TOL * scale:.3e}), |Hx-g|inf={res:.3e}", flush=True)
    if not ok:
        raise RuntimeError(f"K1 disagrees with the plain version at "
                           f"B={B} N={N}{label}")
    return err


def cholesky_checks(card="", deep=False):
    """K1 against its plain version on the card: agreement over shapes and
    cluster sizes, the upper triangle never read, bad pivots, bit-equal
    repeats; then the times; then both schedules at large N (grid_checks,
    ``deep`` as there). Returns max |Δx| and the paired times."""
    from beam_slam_tpu_torch.ops import cholesky as chol
    kernel, plain = chol.cholesky_solve_batched, \
        chol.cholesky_solve_batched_reference
    slots = chol.cluster_slots(torch.cuda.current_device())
    sizes = [C for C in sorted(slots) if slots[C] >= 1]
    chosen = {B: chol.choose_cluster_size(B, slots) for B in (1, BATCH, 64)}
    print(f"[3] K1 clusters: of C CTAs, one CTA to an SM, the card holds at "
          f"once {slots}; chosen C by batch size {chosen}", flush=True)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for B, N in ((1, 640), (8, 640), (3, 128), (2, 200), (1, 1), (2, 7),
                 (5, 33), (64, 640), (1, 1024)):
        max_err = max(max_err, _chol_compare(chol, *_spd(gen, B, N), ""))
    for C in sizes:
        for B, N in ((2, 200), (1, 640), (1, 1024)):
            max_err = max(max_err, _chol_compare(
                chol, *_spd(gen, B, N), f" C={C}", cluster=C))
    # more clusters than the card holds at once: the rest queue
    C = max(sizes)
    max_err = max(max_err, _chol_compare(
        chol, *_spd(gen, 64, 640),
        f" C={C} ({slots[C]} of 64 clusters resident)", cluster=C))
    H, g = _spd(gen, 3, 640)
    upper = torch.triu(torch.ones(640, 640, dtype=torch.bool, device="cuda"),
                       1)
    max_err = max(max_err, _chol_compare(
        chol, H, g, " upper triangle NaN",
        H_kernel=H.masked_fill(upper, float("nan")).contiguous()))

    # bad pivots: first, in a late panel, last; the fourth system is sound
    H, g = _spd(gen, 4, 640)
    pivots = [1, 500, 640, 0]
    for b, p in enumerate(pivots):
        if p:
            H[b, p - 1, p - 1] = -1.0
    x, info = kernel(H, g)
    x_ref, info_ref = plain(H, g)
    torch.cuda.synchronize()
    err = float((x[3] - x_ref[3]).abs().max())
    if not (info.tolist() == pivots == info_ref.tolist()
            and bool(torch.isnan(x[:3]).all())
            and err <= X_TOL * float(x_ref[3].abs().max())):
        raise RuntimeError(f"indefinite systems: info={info.tolist()} "
                           f"(plain {info_ref.tolist()}), sound system off "
                           f"by {err}")
    H, g = _spd(gen, 2, 128)
    H[1, 7, 7] = -1.0
    x, info2 = kernel(H, g)
    torch.cuda.synchronize()
    if not (info2.tolist() == [0, 8] and bool(torch.isnan(x[1]).all())
            and bool(torch.isfinite(x[0]).all())):
        raise RuntimeError(f"indefinite system: info={info2.tolist()}")
    print(f"[3] indefinite systems: info={info.tolist()} and "
          f"{info2.tolist()} as the plain version's, x NaN there only, the "
          f"sound system within {err:.3e}", flush=True)

    # the split is static and uses no atomics: two launches, the same bits
    H, g = _spd(gen, BATCH, 640)
    x1, _ = kernel(H, g)
    x2, _ = kernel(H, g)
    torch.cuda.synchronize()
    if not torch.equal(x1, x2):
        raise RuntimeError("K1: two launches on one input differ")
    print(f"[3] K1 B={BATCH} N=640: two launches give bit-equal x",
          flush=True)

    times = {}
    for B in (1, BATCH, 64):
        H, g = _spd(gen, B, 640)
        times[B] = _paired_ms(lambda: kernel(H, g), lambda: plain(H, g),
                              reps=20 if B < 64 else 5)
        per_c = {C: round(_event_ms(lambda: kernel(H, g, cluster=C), 20), 4)
                 for C in sizes if B < 64}
        print(f"[3] K1 B={B} N=640: kernel {times[B][0]:.3f} ms at C="
              f"{chosen[B]}, plain {times[B][1]:.3f} ms"
              + (f"; kernel ms by cluster size {per_c}" if per_c else "")
              + f" (CUDA events, {card})", flush=True)
    # the smoothers' system: 990 dof + the trash dof, padded to 1024 (both
    # schedules' times against the library pair: grid_checks)
    H, g = _spd(gen, 1, 1024)
    per_c = {C: round(_event_ms(lambda: kernel(H, g, cluster=C), 20), 4)
             for C in sizes}
    print(f"[3] K1 cluster schedule B=1 N=1024: kernel ms by cluster size "
          f"{per_c} (CUDA events, {card})", flush=True)
    # what a panel step of the cluster schedule costs at B=1: the time
    # against N (N/32 steps)
    by_n = {}
    for N in (32, 64, 128, 256, 384, 512, 640, 1024):
        H, g = _spd(gen, 1, N)
        by_n[N] = round(_event_ms(
            lambda: kernel(H, g, schedule="cluster"), 20), 4)
    print(f"[3] K1 cluster schedule B=1 at C={chosen[1]}, kernel ms by N: "
          f"{by_n} (CUDA events, {card})", flush=True)
    max_err = max(max_err, grid_checks(chol, card, times, deep))
    return dict(max_err=max_err, times=times)


# The shapes at which both schedules of K1 are held against the plain
# version: the smoothers' 1024, the global graph's and LVIO's 2048, the
# 1000-keyframe pose graph's 6000, sizes between, an odd N, and batches.
K1_GRID_SHAPES = ((1, 1024), (1, 1536), (1, 2000), (1, 2048), (1, 4096),
                  (1, 6000), (2, 2048), (8, 1024), (1, 6001))


def grid_checks(chol, card="", times=None, deep=False):
    """K1's two schedules at large N: each, forced and by the rule, against
    the plain version over K1_GRID_SHAPES; the grid schedule with a NaN
    upper triangle, bad pivots and a bit-equal repeat; paired times of both
    schedules against the library pair at (1, N) for the path's N. ``deep``
    (``chip_smoke.py k1``) adds the times by N and by (B, N) that the rule's
    thresholds come from. Returns max |Δx|; adds the times to ``times``."""
    times = {} if times is None else times
    dev = torch.cuda.current_device()
    slots, ctas = chol.cluster_slots(dev), chol.grid_ctas(dev)
    rule = {(B, N): chol.choose_schedule(B, N, ctas, slots)
            for B, N in K1_GRID_SHAPES}
    print(f"[3] K1 schedules: grid of {ctas} CTAs, panel "
          f"{chol.GRID_PANEL}; the rule picks {rule}", flush=True)
    max_err = 0.0
    for i, (B, N) in enumerate(K1_GRID_SHAPES):
        H, g = _spd_card(100 + i, B, N)
        for sched in (None, "cluster", "grid"):
            label = f" schedule {sched or 'by the rule: ' + rule[(B, N)]}"
            max_err = max(max_err, _chol_compare(chol, H, g, label,
                                                 schedule=sched))
    for N in (2048, 6001):
        H, g = _spd_card(200 + N, 2, N)
        upper = torch.triu(torch.ones(N, N, dtype=torch.bool,
                                      device="cuda"), 1)
        max_err = max(max_err, _chol_compare(
            chol, H, g, " grid, upper triangle NaN", schedule="grid",
            H_kernel=H.masked_fill(upper, float("nan")).contiguous()))

    # bad pivots: first, inside a later 32-wide sub-panel, last; the fourth
    # system is sound
    H, g = _spd_card(300, 4, 2048)
    pivots = [1, 1000, 2048, 0]
    for b, p in enumerate(pivots):
        if p:
            H[b, p - 1, p - 1] = -1.0
    x, info = chol.cholesky_solve_batched(H, g, schedule="grid")
    x_ref, info_ref = chol.cholesky_solve_batched_reference(H, g)
    torch.cuda.synchronize()
    err = float((x[3] - x_ref[3]).abs().max())
    if not (info.tolist() == pivots == info_ref.tolist()
            and bool(torch.isnan(x[:3]).all())
            and err <= X_TOL * float(x_ref[3].abs().max())):
        raise RuntimeError(f"K1 grid, indefinite systems: info="
                           f"{info.tolist()} (plain {info_ref.tolist()}), "
                           f"sound system off by {err}")
    H, g = _spd_card(301, 1, 2048)
    x1, _ = chol.cholesky_solve_batched(H, g, schedule="grid")
    x2, _ = chol.cholesky_solve_batched(H, g, schedule="grid")
    torch.cuda.synchronize()
    if not torch.equal(x1, x2):
        raise RuntimeError("K1 grid: two launches on one input differ")
    print(f"[3] K1 grid at N=2048: bad pivots give info={info.tolist()} as "
          f"the plain version's, x NaN there only, the sound system within "
          f"{err:.3e}; two launches give bit-equal x", flush=True)

    # paired times (plain, kernel, kernel, plain) at the path's N, B = 1
    def kernel_ms(H, g, **knobs):
        return _event_ms(lambda: chol.cholesky_solve_batched(H, g, **knobs),
                         10)
    for N in (1024, 2048, 6000):
        H, g = _spd_card(400 + N, 1, N)
        row = {}
        for sched in ("cluster", "grid"):
            row[sched] = _paired_ms(
                lambda: chol.cholesky_solve_batched(H, g, schedule=sched),
                lambda: chol.cholesky_solve_batched_reference(H, g),
                reps=10)
        default = chol.choose_schedule(1, N, ctas, slots)
        times[(1, N)] = row[default] + (default,)
        bound = _chol_bound(1, N)
        print(f"[3] K1 B=1 N={N}: cluster {row['cluster'][0]:.4f} ms, grid "
              f"{row['grid'][0]:.4f} ms, by the rule ({default}) "
              f"{row[default][0]:.4f} ms; library pair (cholesky_ex + "
              f"cholesky_solve) {row[default][1]:.4f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}) (CUDA events, in turns, "
              f"{card})", flush=True)
    # where the rule keeps the cluster schedule: the flagship's, the batched
    # refinement's and the submap batch's shapes, timed in turns (forced,
    # rule, rule, forced)
    for B, N in ((1, 640), (BATCH, 640), (64, 640), (5, 256)):
        H, g = _spd_card(450 + B, B, N)
        default = chol.choose_schedule(B, N, ctas, slots)
        d_ms, c_ms = _paired_ms(
            lambda: chol.cholesky_solve_batched(H, g),
            lambda: chol.cholesky_solve_batched(H, g, schedule="cluster"))
        print(f"[3] K1 B={B} N={N}: by the rule ({default}) {d_ms:.4f} ms, "
              f"the cluster schedule forced {c_ms:.4f} ms (CUDA events, in "
              f"turns, {card})", flush=True)
    if not deep:
        return max_err
    by_n = {}
    for N in (512, 640, 768, 896, 1024, 1536, 2048, 3072, 4096, 6000):
        H, g = _spd_card(600 + N, 1, N)
        by_n[N] = {s: round(kernel_ms(H, g, schedule=s), 4)
                   for s in ("cluster", "grid")}
    print(f"[3] K1 ms by N at B=1, per schedule: {by_n} (CUDA events, "
          f"{card})", flush=True)
    by_bn = {}
    for B in (2, 4, 8):
        for N in (640, 1024, 1536, 2048, 3072, 4096):
            H, g = _spd_card(700 + B * N, B, N)
            by_bn[(B, N)] = {s: round(kernel_ms(H, g, schedule=s), 4)
                             for s in ("cluster", "grid")}
    print(f"[3] K1 schedules by (B, N), ms per schedule: {by_bn} (CUDA "
          f"events, {card})", flush=True)
    return max_err


def _so3_err(q_a, q_b) -> float:
    """Angle of q_a⁻¹ q_b (host arrays)."""
    from beam_slam_tpu_torch.core import lie
    qa, qb = (torch.as_tensor(np.asarray(x, np.float32)) for x in (q_a, q_b))
    return float(torch.linalg.vector_norm(
        lie.so3_log(lie.quat_mul(lie.quat_conj(qa), qb))))


def _lio_poses(n):
    """Ground-truth poses along a path through the scan's environment:
    ~0.12 m and ~0.9° of yaw per scan, with some sway."""
    from beam_slam_tpu_torch.core import lie
    poses = []
    for i in range(n):
        rv = torch.tensor([0.004 * np.sin(i), 0.003 * (np.cos(i) - 1.0),
                           0.015 * i], dtype=torch.float32)
        p = np.array([0.12 * i, 0.04 * np.sin(0.7 * i), 0.005 * i],
                     np.float32)
        poses.append((lie.so3_exp_quat(rv).numpy(), p))
    return poses


def _perturbed(q, p, rng, rot=SEED_ROT, trans=SEED_TRANS):
    from beam_slam_tpu_torch.core import lie
    dq = lie.so3_exp_quat(torch.as_tensor(
        (rng.standard_normal(3) * rot).astype(np.float32)))
    q_s = lie.quat_mul(torch.as_tensor(q), dq).numpy()
    return q_s, (p + rng.standard_normal(3).astype(np.float32) * trans)


def _observed_grid(cloud, q, p, device):
    """The real cloud seen from pose (q, p): sensor-frame points T⁻¹·world,
    organised (tests/test_real_scan.py:59-66)."""
    from beam_slam_tpu_torch.core import lie
    from beam_slam_tpu_torch.lidar.cloud import organize_scan
    pts = lie.quat_rotate(lie.quat_conj(torch.as_tensor(q))[None],
                          torch.as_tensor(cloud.xyz - p)).numpy()
    return organize_scan(pts, cloud.ring, cloud.time, N_RINGS, WIDTH,
                         device=device)


def _load_scan():
    from beam_slam_tpu_torch.lidar.pcd import load_pcd
    with tempfile.TemporaryDirectory() as d:
        raw = Path(d) / "test_scan_vlp16.pcd"
        raw.write_bytes(gzip.decompress(SCAN_GZ.read_bytes()))
        return load_pcd(str(raw))


def _gt_rel(poses, i, j):
    from beam_slam_tpu_torch.lidar.scan_registration import _pose_delta
    return _pose_delta(poses[i][0], poses[i][1], poses[j][0], poses[j][1])


def _check_factors(rels, poses, stamps, label, bounds=(GT_TRANS, GT_ROT)):
    """Every relative factor within the ground-truth ``bounds`` (m, rad);
    returns the worst (trans, rot) error."""
    worst = (0.0, 0.0)
    for f in rels:
        i, j = stamps.index(f.stamp_i), stamps.index(f.stamp_j)
        dq_gt, dp_gt = _gt_rel(poses, i, j)
        e_p = float(np.linalg.norm(np.asarray(f.dp) - dp_gt))
        e_r = _so3_err(f.dq, dq_gt)
        if not (e_p < bounds[0] and e_r < bounds[1]) or f.sensor != "lidar":
            raise RuntimeError(f"{label}: factor {i}->{j} off ground truth by "
                               f"{e_p:.4f} m / {e_r:.4f} rad")
        worst = (max(worst[0], e_p), max(worst[1], e_r))
    return worst


def run_lio(device, n_scans=LIO_SCANS, map_size=None, card=""):
    """The LIO front end, sync strategy, from configs/ on ``device``.
    Returns what the later phases reuse."""
    from beam_slam_tpu_torch import device as tdev
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.solver.smoother import Transaction
    from beam_slam_tpu_torch.ops import knn

    cloud = _load_scan()
    poses = _lio_poses(n_scans)
    rng = np.random.default_rng(LIO_SEED)
    seeds = [poses[0]] + [_perturbed(q, p, rng) for q, p in poses[1:]]
    stamps = [0.1 * i for i in range(n_scans)]
    rcfg, mcfg = LIO_JSON
    if map_size is not None:   # a rehearsal off the card: a smaller map
        rcfg = dict(json.loads((ROOT / "configs" / rcfg).read_text()),
                    map_size=map_size)
    strat, feat_cfg = tsr.create_scan_registration(
        rcfg, mcfg, config_root=str(ROOT / "configs"),
        **({} if device == "cuda" else {"device": device}))
    cuda = strat.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    grids, fcs = [], []
    for q, p in poses:
        grids.append(_observed_grid(cloud, q, p,
                                    None if cuda else device))
        fcs.append(feat.extract_features(grids[-1], feat_cfg))
    sync()

    host_waits = [0]
    numpy_fn = tdev.HostCopy.numpy

    def counted_numpy(self):
        host_waits[0] += self._event is not None
        return numpy_fn(self)

    knn.knn_topk.launches = 0
    rels, abss, ms, syncs, last = [], [], [], [], None
    for i in range(n_scans):
        if i == n_scans - 1:  # the inputs of the last registration
            last = dict(fc=fcs[i], world=strat.map.world_frame(),
                        seed=seeds[i], gt=poses[i])
        txn = Transaction(stamp=stamps[i])
        sync()
        host_waits[0] = 0
        tdev.HostCopy.numpy = counted_numpy
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode(1)
            try:
                ok = strat.register_new_scan(stamps[i], fcs[i], *seeds[i],
                                             txn)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
                tdev.HostCopy.numpy = numpy_fn
        sync()
        if i > 0:
            ms.append(1e3 * (time.perf_counter() - t0))
            syncs.append(host_waits[0] + sum(
                "synchroniz" in str(w.message) for w in caught))
        if not ok:
            raise RuntimeError(f"LIO: scan {i} was not accepted")
        rels += txn.rel_poses
        abss += txn.abs_poses
    launches = knn.knn_topk.launches
    if len(abss) != 1 or len(rels) != n_scans - 1:
        raise RuntimeError(f"LIO: {len(abss)} priors, {len(rels)} factors")
    worst = _check_factors(rels, poses, stamps, "LIO")
    if cuda and launches < 2 * (n_scans - 1):
        raise RuntimeError(f"LIO: {launches} K2 launches for "
                           f"{n_scans - 1} registrations")
    me, _, msf, _ = last["world"]
    print(f"[6] LIO at {N_RINGS}x{WIDTH}: {n_scans} scans accepted, "
          f"{len(rels)} chained factors, worst {worst[0]:.4f} m / "
          f"{worst[1]:.4f} rad off ground truth (bounds {GT_TRANS} / "
          f"{GT_ROT}); world map {me.shape[0]} edges + {msf.shape[0]} "
          f"surfaces, scan {fcs[0].edge_strong.shape[0] + fcs[0].edge_weak.shape[0]}"
          f" + {fcs[0].surf_strong.shape[0] + fcs[0].surf_weak.shape[0]}; "
          f"{launches} K2 launches; register_new_scan median "
          f"{statistics.median(ms):.2f} ms over {len(ms)} (host clock, "
          f"synchronised; {card}); host syncs per scan "
          f"{statistics.mean(syncs):.1f} (min {min(syncs)}, max "
          f"{max(syncs)})", flush=True)
    return dict(strat=strat, feat_cfg=feat_cfg, grids=grids, fcs=fcs,
                seeds=seeds, poses=poses, stamps=stamps, rels=rels,
                launches=launches, last=last, ms=ms)


def registration_card_vs_cpu(lio):
    """One registration on the card against the port's CPU plain path on
    the same features, map and seed."""
    from beam_slam_tpu_torch.lidar import registration as treg
    last, cfg = lio["last"], lio["strat"].reg_cfg
    dev = last["world"][0].device
    q0 = torch.as_tensor(last["seed"][0], device=dev)
    p0 = torch.as_tensor(last["seed"][1], device=dev)
    res = treg.register_loam(last["fc"], *last["world"], q0, p0, cfg)
    res_cpu = treg.register_loam(last["fc"].to("cpu"),
                                 *(w.cpu() for w in last["world"]),
                                 q0.cpu(), p0.cpu(), cfg)
    dp = float(torch.linalg.vector_norm(res.p.cpu() - res_cpu.p))
    dr = _so3_err(res.q.cpu().numpy(), res_cpu.q.numpy())
    same = bool(res.converged) == bool(res_cpu.converged)
    print(f"[6] one registration, card vs CPU plain path: |dp|={dp:.2e} m "
          f"(bound {CARD_CPU_DP}), rotation {dr:.2e} rad (bound "
          f"{CARD_CPU_ROT}), converged {bool(res.converged)} / "
          f"{bool(res_cpu.converged)}, inliers {int(res.n_inliers)} / "
          f"{int(res_cpu.n_inliers)}", flush=True)
    if not (dp <= CARD_CPU_DP and dr <= CARD_CPU_ROT and same):
        raise RuntimeError("registration on the card disagrees with the CPU "
                           "plain path")


def registration_stages(lio, card=""):
    """Where one full-width registration's time goes (host clock with a
    sync after every stage)."""
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import registration as treg
    last, strat = lio["last"], lio["strat"]
    dev = last["world"][0].device
    q0 = torch.as_tensor(last["seed"][0], device=dev)
    p0 = torch.as_tensor(last["seed"][1], device=dev)
    stages = {"features": [], "world map": [], "fits": [], "gn steps": [],
              "register_loam": []}

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[key].append(1e3 * (time.perf_counter() - t0))
        return out

    fit, step = treg._fit_corr, treg._gn_step
    for _ in range(5):
        timed("features", feat.extract_features, lio["grids"][-1],
              lio["feat_cfg"])
        strat.map._cache = None
        timed("world map", strat.map.world_frame)
        treg._fit_corr = lambda *a, **kw: timed("fits", fit, *a, **kw)
        treg._gn_step = lambda *a, **kw: timed("gn steps", step, *a, **kw)
        try:
            timed("register_loam", treg.register_loam, last["fc"],
                  *last["world"], q0, p0, strat.reg_cfg)
        finally:
            treg._fit_corr, treg._gn_step = fit, step
    n_fits = len(stages["fits"]) // 5
    n_steps = len(stages["gn steps"]) // 5
    med = {k: statistics.median(v) for k, v in stages.items()}
    per_fit = statistics.median(stages["fits"])
    per_step = statistics.median(stages["gn steps"])
    print(f"[6] one full-width registration, synced stages (median of 5; "
          f"{card}): features {med['features']:.2f} ms, world map assembly "
          f"+ dedup {med['world map']:.2f} ms, register_loam "
          f"{med['register_loam']:.2f} ms = {n_fits} fits x "
          f"{per_fit:.2f} ms + {n_steps} GN steps x {per_step:.2f} ms "
          f"+ rest", flush=True)

    # the same registration with no sync inside, then once under the
    # profiler: device time (kernels and copies, one stream) against wall
    def reg():
        return treg.register_loam(last["fc"], *last["world"], q0, p0,
                                  strat.reg_cfg)

    wall = _wall_ms(reg, 5)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):  # the profiler now and then loses events: retry
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            reg()
            torch.cuda.synchronize()
        on_dev = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        knn_dev = sum(e.time_range.elapsed_us() for e in on_dev
                      if "knn_topk_kernel" in e.name) / 1e3
        if knn_dev > 0:
            break
    else:
        raise RuntimeError("the profiler shows no K2 kernel (knn_topk_kernel) "
                           "in a registration")
    busy = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3
    print(f"[6] register_loam unsynced: median {wall:.2f} ms over 5; under "
          f"the profiler {len(on_dev)} device ops, device time {busy:.2f} ms "
          f"(K2 {knn_dev:.2f} ms), so the card is idle "
          f"{100 * (1 - busy / wall):.1f}% of the unsynced wall ({card})",
          flush=True)


def _placed(fc, q, p):
    """A scan's edge and surface features placed in the world at (q, p)."""
    from beam_slam_tpu_torch.core import lie
    dev = fc.edge_strong.device
    q = torch.as_tensor(q, device=dev)
    p = torch.as_tensor(p, device=dev)
    return tuple((lie.quat_rotate(q[None], torch.cat(pts)) + p[None])
                 .contiguous() for pts in ((fc.edge_strong, fc.edge_weak),
                                           (fc.surf_strong, fc.surf_weak)))


def lio_knn_inputs(device):
    """K2's inputs at the LIO path's two shapes without running a
    registration: the last scan's features at its ground-truth pose against
    the world map of the scans before it at theirs (the same configs,
    shapes and map order as phase 6's map). Returns [(query, ref, valid, k,
    label)] for edges (k=5) and surfaces (k=10)."""
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.lidar.registration_map import RegistrationMap
    cloud = _load_scan()
    poses = _lio_poses(LIO_SCANS)
    strat, feat_cfg = tsr.create_scan_registration(
        *LIO_JSON, config_root=str(ROOT / "configs"), device=device)
    grid_dev = None if device == "cuda" else device
    fcs = [feat.extract_features(_observed_grid(cloud, q, p, grid_dev),
                                 feat_cfg) for q, p in poses]
    world = RegistrationMap(map_size=strat.map.map_size,
                            world_voxel=strat.map.world_voxel, device=device)
    n = len(fcs) - 1
    for i in range(max(0, n - world.map_size), n):
        world.add_scan(0.1 * i, *poses[i], fcs[i])
    me, mev, ms_, msv = world.world_frame()
    e_q, s_q = _placed(fcs[n], *poses[n])
    return [(e_q, me, mev, 5, "edges"), (s_q, ms_, msv, 10, "surfaces")]


def knn_counts(device):
    """Insertions of K2's schedule (its mirror) at the LIO shapes: per warp,
    the valid refs it scans and the refs at which some lane inserts into
    its k-list, for S·W = 1, 8, 32 parts of R, with and without the shared
    threshold; the map in its own order (valid refs first) and shuffled."""
    from beam_slam_tpu_torch.ops import knn
    for q, r, v, k, label in lio_knn_inputs(device):
        perm = torch.randperm(r.shape[0], generator=torch.Generator()
                              .manual_seed(0)).to(r.device)
        for order, (rr, vv) in (("map order", (r, v)),
                                ("shuffled", (r[perm].contiguous(),
                                              v[perm].contiguous()))):
            for S, W in ((1, 1), (1, 8), (4, 8)):
                for prune in (None, "<="):
                    c = {}
                    t0 = time.perf_counter()
                    knn.knn_topk_split_mirror(q, rr, vv, k, cluster=S,
                                              warps=W, prune=prune, counts=c)
                    w = c["warp_insertions"].double()
                    n = c["scanned"].double()
                    print(f"[counts] {label} ({q.shape[0]}, {r.shape[0]}, "
                          f"k={k}), {int(v.sum())} valid, {order}, "
                          f"S·W={S * W} (S={S}, W={W}), threshold "
                          f"{'off' if prune is None else 'on'}: valid refs "
                          f"a warp scans mean {float(n.mean()):.1f}, max "
                          f"{int(n.max())}; warp insertion steps mean "
                          f"{float(w.mean()):.1f}, max {int(w.max())}; "
                          f"lane insertions per query "
                          f"{c['lane_insertions'] / q.shape[0]:.1f} "
                          f"({time.perf_counter() - t0:.1f} s, {device})",
                          flush=True)


MOMENT_RADII = {"edges": 0.35, "surfaces": 0.3}


def moments_checks(inputs, card=""):
    """K3 on the card: against its plain version at the LIO path's two
    shapes (``inputs`` as ``lio_knn_inputs`` gives them, at the radii of
    MOMENT_RADII) at the chosen and at every cluster size, and at edge
    shapes; bit-equal repeats; then the times of both LIO shapes against the
    plain version."""
    from beam_slam_tpu_torch.ops import knn, moments
    dev = torch.cuda.current_device()
    slots = moments.cluster_slots(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = [S for S in knn.CLUSTER_SIZES if slots[S] >= 1]
    chosen = {label: knn.choose_cluster_size(q.shape[0], slots, n_sms)
              for q, _, _, _, label in inputs}
    print(f"[7] K3 clusters: of S CTAs, the card holds at once {slots}; "
          f"chosen S {chosen}", flush=True)
    err, n_nb = 0.0, {}
    for q, r, v, _, label in inputs:
        e, n_nb[label] = _moments_check(moments, q, r, v,
                                        MOMENT_RADII[label], label)
        err = max(err, e)
        for S in sizes:
            err = max(err, _moments_check(moments, q, r, v,
                                          MOMENT_RADII[label], label,
                                          cluster=S)[0])
    gen = torch.Generator().manual_seed(3)
    rq = (torch.rand(1000, 3, generator=gen) * 20 - 10).cuda()
    rr = (torch.rand(3001, 3, generator=gen) * 20 - 10).cuda()
    rv = (torch.rand(3001, generator=gen) < 0.7).cuda()
    few = torch.zeros(64, dtype=torch.bool)
    few[[3, 17, 40]] = True
    few = few.cuda()
    for args in ((rq, rr, rv, 1.5, "ragged"),
                 (rq[:100], rr[:64], few, 30.0, "3 valid of 64"),
                 (rq[:33], rr, rv, 2.0, "one query in the last tile")):
        err = max(err, _moments_check(moments, *args)[0])
    # the 61 invalid refs stand at the sentinel, inside 3e5; its moments are
    # ~1e11, so its error is held to its own bound and left out of err
    _moments_check(moments, rq[:100], rr[:64], few, 3e5,
                   "sentinel inside the radius")
    for S in sizes:  # R < S·W·T: most warps hold no ref, all reach the merge
        err = max(err, _moments_check(moments, rq, rr[:100], rv[:100], 4.0,
                                      "R=100", cluster=S)[0])
    for q, r, v, _, label in inputs:
        a, b = (moments.raw_moments(q, r, v, MOMENT_RADII[label])
                for _ in range(2))
        if not torch.equal(a, b):
            raise RuntimeError(f"K3 {label}: two launches differ")
    print("[7] K3 at both LIO shapes: two launches give bit-equal moments",
          flush=True)

    times = {}
    for q, r, v, _, label in inputs:
        Q, R, n_valid, rad = q.shape[0], r.shape[0], int(v.sum()), \
            MOMENT_RADII[label]
        m_ms, m_plain = _paired_ms(
            lambda: moments.raw_moments(q, r, v, rad),
            lambda: moments.raw_moments_reference(q, r, v, rad))
        dev_ms = _device_ms(lambda: moments.raw_moments(q, r, v, rad),
                            "radius_moments_kernel")
        per_s = {S: round(_device_ms(
            lambda: moments.raw_moments(q, r, v, rad, cluster=S),
            "radius_moments_kernel"), 4) for S in sizes}
        bound = _moments_bound(Q, R, n_valid, n_nb[label])
        times[label] = dict(ms=dev_ms, call_ms=m_ms, plain=m_plain,
                            bound=bound)
        print(f"[7] K3 {label} ({Q}, {R}, rad={rad}), {n_valid} valid refs, "
              f"{n_nb[label]} neighbours: kernel {dev_ms:.4f} ms on the "
              f"device at S={chosen[label]} (profiler), {m_ms:.4f} ms a call "
              f"back to back (CUDA events); plain {m_plain:.3f} ms (CUDA "
              f"events), no single PyTorch call computes it; bound "
              f"{bound[0]:.4f} ms ({bound[1]}); kernel device ms by cluster "
              f"size {per_s} ({card})", flush=True)
    return dict(err=err, times=times)


def kernel_checks(lio, card=""):
    """K2 (``knn_checks``) and K3 (``moments_checks``) against their plain
    versions on the card at the LIO path's own shapes and data, and at edge
    shapes; then each timed."""
    last = lio["last"]
    me, mev, ms_, msv = last["world"]
    inputs = [(q, r, v, k, label) for q, (r, v), k, label in zip(
        _placed(last["fc"], *last["gt"]), ((me, mev), (ms_, msv)), (5, 10),
        ("edges", "surfaces"))]
    return dict(k2=knn_checks(inputs, card), k3=moments_checks(inputs, card))


def run_pipelined(lio, card=""):
    """The pipelined device-map strategy on the same scans and seeds: after
    flush_pending its factors equal the sync strategy's."""
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.solver.smoother import Transaction
    s = lio["strat"]
    pipe = tsr.PipelinedScanToMapRegistration(
        s.params, s.reg_cfg, map_size=s.map.map_size,
        downsample_voxel=s.map.world_voxel, device=s.device)
    rels, ms = [], []
    cuda = s.device.type == "cuda"
    for i, stamp in enumerate(lio["stamps"]):
        txn = Transaction(stamp=stamp)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not pipe.register_new_scan(stamp, lio["fcs"][i], *lio["seeds"][i],
                                      txn):
            raise RuntimeError(f"pipelined: scan {i} refused")
        if i > 0:
            ms.append(1e3 * (time.perf_counter() - t0))
        rels += txn.rel_poses
    txn = Transaction(stamp=99.0)
    pipe.flush_pending(txn)
    rels += txn.rel_poses
    if pipe.failures or len(rels) != len(lio["rels"]):
        raise RuntimeError(f"pipelined: {len(rels)} factors, "
                           f"{pipe.failures} failures")
    gap = (0.0, 0.0)
    for fp, fs in zip(rels, lio["rels"]):
        if (fp.stamp_i, fp.stamp_j) != (fs.stamp_i, fs.stamp_j):
            raise RuntimeError("pipelined: factor stamps differ")
        gap = (max(gap[0], float(np.linalg.norm(np.asarray(fp.dp)
                                                - np.asarray(fs.dp)))),
               max(gap[1], _so3_err(fp.dq, fs.dq)))
    worst = _check_factors(rels, lio["poses"], lio["stamps"], "pipelined")
    print(f"[8] pipelined: {len(rels)} factors after flush, max gap to the "
          f"sync strategy {gap[0]:.2e} m / {gap[1]:.2e} rad (bound "
          f"{PIPE_TOL}), worst {worst[0]:.4f} m / {worst[1]:.4f} rad off "
          f"ground truth; register_new_scan median "
          f"{statistics.median(ms):.2f} ms (host clock, enqueue + in-step "
          f"syncs; {card})", flush=True)
    if not (gap[0] <= PIPE_TOL and gap[1] <= PIPE_TOL):
        raise RuntimeError("pipelined factors differ from the sync "
                           "strategy's")


def run_radius(lio):
    """register_loam in corr_mode="radius" from a cm-level seed (the offsets
    of tests/test_lidar.py's radius test) on two maps: the sequence's own
    map, whose frame has drifted from the world by the registrations'
    errors, held against the kNN registration of the same scan on that map
    from the same seed; and a drift-free map of the same scans' features at
    their ground-truth poses, held against ground truth."""
    from beam_slam_tpu_torch.core import lie
    from beam_slam_tpu_torch.lidar import registration as treg
    from beam_slam_tpu_torch.lidar.registration_map import RegistrationMap
    from beam_slam_tpu_torch.ops import moments
    last, strat = lio["last"], lio["strat"]
    q_gt, p_gt = last["gt"]
    dev = last["world"][0].device
    q0 = lie.quat_mul(torch.as_tensor(q_gt), lie.so3_exp_quat(
        torch.tensor([0.008, -0.006, 0.004]))).to(dev)
    p0 = torch.as_tensor(p_gt + np.array([0.04, -0.03, 0.02], np.float32),
                         device=dev)
    cfg = strat.reg_cfg._replace(corr_mode="radius")
    gt_map = RegistrationMap(map_size=strat.map.map_size,
                             world_voxel=strat.map.world_voxel, device=dev)
    n = len(lio["fcs"]) - 1
    for i in range(max(0, n - strat.map.map_size), n):
        gt_map.add_scan(lio["stamps"][i], *lio["poses"][i], lio["fcs"][i])
    moments.raw_moments.launches = 0
    res = treg.register_loam(last["fc"], *last["world"], q0, p0, cfg)
    res_gt = treg.register_loam(last["fc"], *gt_map.world_frame(), q0, p0,
                                cfg)
    converged = bool(res.converged) and bool(res_gt.converged)
    launches = moments.raw_moments.launches
    knn_res = treg.register_loam(last["fc"], *last["world"], q0, p0,
                                 strat.reg_cfg)
    p, p_gt_map = res.p.cpu().numpy(), res_gt.p.cpu().numpy()
    to_knn = float(np.linalg.norm(p - knn_res.p.cpu().numpy()))
    to_gt = float(np.linalg.norm(p - p_gt))
    gt_err = float(np.linalg.norm(p_gt_map - p_gt))
    print(f"[9] radius mode: converged {converged}, {int(res.n_inliers)} / "
          f"{int(res_gt.n_inliers)} inliers; on the sequence's map "
          f"{to_knn:.4f} m from its kNN registration (bound {RADIUS_GT}) and "
          f"{to_gt:.4f} m from ground truth (bound {GT_TRANS}); on the "
          f"ground-truth map {gt_err:.4f} m from ground truth (bound "
          f"{RADIUS_GT}); {launches} K3 launches", flush=True)
    if not (converged and to_knn < RADIUS_GT and to_gt < GT_TRANS
            and gt_err < RADIUS_GT and (dev.type != "cuda" or launches > 0)):
        raise RuntimeError("radius-mode registration failed")
    return launches


def _session_trajectory(device):
    """Ground truth of the LIO+IMU session: phase 6's kind of path, a
    keyframe every 0.25 s ~0.05–0.19 m and ~1° apart, through the vendored
    scan's environment."""
    from beam_slam_tpu_torch.utils import sim
    return sim.AnalyticTrajectory(
        amp_p=(0.3, 0.25, 0.05), freq_p=(0.9, 0.7, 1.1),
        v_drift=(0.45, 0.0, 0.0), amp_r=(0.03, 0.03, 0.15),
        freq_r=(0.8, 1.2, 0.6), device=device)


def _busy_ms(fn, marker="chol_solve"):
    """(device ms, device ops) of one call of ``fn`` under the profiler:
    kernels and copies on the card's clock (one stream, no overlap); None
    when the profiler lost the window's events (it now and then does: no
    event whose name holds ``marker``, K1's kernel by default; any event
    for ``marker=""``). Only the card's activity is traced: the host's ops
    are not read, and turning tens of thousands of them into events took
    ~1 ms each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not any(marker in e.name for e in on_dev):
        return None
    return sum(e.time_range.elapsed_us() for e in on_dev) / 1e3, len(on_dev)


def run_session(card="", device="cuda", n_keyframes=None):
    """The LIO+IMU session on the card at configs/lio.yaml's capacities:
    the fixed-lag smoother (sync tick) fed, every 0.25 s keyframe, with the
    scan registered scan-to-map from the IMU's predicted pose (K2), the
    preintegrated IMU factor and the gravity factor in one transaction;
    every LM step of every tick solves the 1024² reduced system with K1.
    Returns the launch counts and K1's times on the session's system.
    ``device="cpu"`` (and fewer ``n_keyframes``) rehearses the session's
    logic off the card: no profiler, no K1 comparison or times."""
    from beam_slam_tpu_torch import device as tdev
    from beam_slam_tpu_torch.core import lie
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.models.gravity_alignment import (
        GravityAlignment, GravityAlignmentParams)
    from beam_slam_tpu_torch.models.inertial_odometry import (
        ImuParams, InertialOdometry)
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.solver.smoother import (FixedLagSmoother,
                                                     Transaction)
    from beam_slam_tpu_torch.utils import sim

    cuda = device == "cuda"
    dev = None if cuda else device   # entry points: None is the card

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = lio_smoother_config()
    sm = FixedLagSmoother(cfg, device=dev)
    sm.register_extrinsic(tsr.LIDAR_SENSOR, np.array([1, 0, 0, 0],
                                                     np.float32),
                          np.zeros(3, np.float32))
    io = InertialOdometry(sm, ImuParams(), device=dev)
    grav = GravityAlignment(sm, GravityAlignmentParams(**LIO_GRAVITY))
    strat, feat_cfg = tsr.create_scan_registration(
        *LIO_JSON, config_root=str(ROOT / "configs"), device=dev)
    traj = _session_trajectory(device)
    imu = sim.imu_measurements(
        traj, 0.0, SESSION_S, IMU_RATE,
        generator=torch.Generator().manual_seed(SESSION_SEED),
        sig_w=SESSION_IMU_SIGMA[0], sig_a=SESSION_IMU_SIGMA[1], device=dev)
    imu_t, imu_w, imu_a = tdev.to_numpy(imu.t, imu.w_body, imu.a_body)
    imu_t = imu_t.astype(np.float64)
    stamps = [round(SESSION_KF_DT * k, 6)
              for k in range(int(round(SESSION_S / SESSION_KF_DT)) + 1)]
    stamps = stamps[:n_keyframes]
    gt = traj.sample(torch.tensor(stamps, dtype=torch.float32,
                                  device=device))
    gt_q, gt_p, gt_v = tdev.to_numpy(gt.q, gt.p, gt.v)
    cloud = _load_scan()
    max_window = int(np.ceil(cfg.lag_duration / SESSION_KF_DT)) + 2

    host_waits = [0]
    numpy_fn = tdev.HostCopy.numpy

    def counted_numpy(self):
        host_waits[0] += self._event is not None
        return numpy_fn(self)

    def tick():
        sync()
        host_waits[0] = 0
        tdev.HostCopy.numpy = counted_numpy
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode(1)
            try:
                diag = sm.run_once()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
                tdev.HostCopy.numpy = numpy_fn
        sync()
        wall = 1e3 * (time.perf_counter() - t0)
        return diag, wall, host_waits[0] + sum(
            "synchroniz" in str(w.message) for w in caught)

    n_prof = SESSION_PROFILED if cuda else 0
    chol.cholesky_solve_batched.launches = 0
    knn.knn_topk.launches = 0
    fed, ticks, prof = 0, [], []
    for k, t_k in enumerate(stamps):
        while fed < len(imu_t) and imu_t[fed] <= t_k + 1e-9:
            io.process_imu(float(imu_t[fed]), imu_w[fed], imu_a[fed])
            grav.process_imu(float(imu_t[fed]), imu_a[fed])
            fed += 1
        grid = _observed_grid(cloud, gt_q[k], gt_p[k], dev)
        fc = feat.extract_features(grid, feat_cfg)
        txn = Transaction(stamp=t_k)
        if k == 0:
            txn.add_imu_state(t_k, gt_q[0], gt_p[0], gt_v[0])
            q_s, p_s = gt_q[0], gt_p[0]
        else:
            q_s, p_s, _ = io.model.get_pose(t_k)   # the IMU's prediction
            if not io.model.register_factor(t_k, txn):
                raise RuntimeError(f"session: no IMU factor at {t_k}")
        if not strat.register_new_scan(t_k, fc, q_s, p_s, txn):
            raise RuntimeError(f"session: scan at {t_k} not registered")
        grav.process_stamp(t_k, txn)
        sm.send_transaction(txn)
        k1_before = chol.cholesky_solve_batched.launches
        if k >= len(stamps) - n_prof:
            seen = _busy_ms(lambda: ticks.append(tick()))
            prof.append(seen and seen + (ticks[-1][1],))
        else:
            ticks.append(tick())
        diag = ticks[-1][0]
        ticks[-1] += (chol.cholesky_solve_batched.launches - k1_before,)
        if k == 0:
            io.initialize(t_k, gt_q[0], gt_p[0], gt_v[0])
        c0, c1 = float(diag.initial_cost), float(diag.final_cost)
        if not (np.isfinite(c1) and c1 <= c0):
            raise RuntimeError(f"session tick {k}: cost {c0} -> {c1}")
        if len(sm.current_stamps()) > max_window:
            raise RuntimeError(f"session tick {k}: {len(sm.current_stamps())}"
                               f" states in the window (bound {max_window})")
    launches = dict(k1=chol.cholesky_solve_batched.launches,
                    k2=knn.knn_topk.launches)

    # checks on the end state
    worst = (0.0, 0.0)
    for t in sm.current_stamps():
        k = stamps.index(t)
        st = sm.get_state(t)
        e_p = float(np.linalg.norm(st["p"] - gt_p[k]))
        e_r = _so3_err(st["q"], gt_q[k])
        worst = (max(worst[0], e_p), max(worst[1], e_r))
    if not (worst[0] < GT_TRANS and worst[1] < GT_ROT):
        raise RuntimeError(f"session: window {worst[0]:.4f} m / "
                           f"{worst[1]:.4f} rad off ground truth")
    c = sm.counters
    if not sm._last_marginalized_stamps or c["dropped_transactions"] or \
            c["forced_state_marginalizations"]:
        raise RuntimeError(f"session: marginalized "
                           f"{len(sm._last_marginalized_stamps)}, counters {c}")
    if cuda and (launches["k1"] < len(stamps)
                 or launches["k2"] < 2 * (len(stamps) - 1)):
        raise RuntimeError(f"session: launches {launches}")
    steady = ticks[1:len(ticks) - n_prof]   # not the first, not profiled
    walls = [t[1] for t in steady]
    print(f"[10] LIO+IMU session (the sync tick; phase 11 runs the async "
          f"one), configs/lio.yaml capacities ({cfg.max_states} states, "
          f"lag {cfg.lag_duration} s, LM <= {cfg.solver.max_iterations} "
          f"steps with early exit), {len(stamps)} keyframes every "
          f"{SESSION_KF_DT} s over {SESSION_S} s, IMU at {IMU_RATE:.0f} Hz: "
          f"window {len(sm.current_stamps())} states (bound {max_window}), "
          f"{len(sm._last_marginalized_stamps)} states marginalized, worst "
          f"{worst[0]:.4f} m / {worst[1]:.4f} rad off ground truth (bounds "
          f"{GT_TRANS} / {GT_ROT}); counters {c}; K1 launches "
          f"{launches['k1']}, K2 launches {launches['k2']}", flush=True)
    print(f"[10] session ticks ({card}): wall median "
          f"{statistics.median(walls):.1f} ms (min {min(walls):.1f}, max "
          f"{max(walls):.1f}) over {len(steady)}; solve "
          f"{1e3 * sm.total_solve_time / sm.solve_count:.1f} ms a tick "
          f"(mean of {sm.solve_count}); accepted LM steps a tick "
          f"{statistics.mean(int(t[0].iterations) for t in steady):.2f}; K1 "
          f"launches (LM steps run) a tick "
          f"{statistics.mean(t[3] for t in steady):.2f}, "
          f"{sum(t[3] >= cfg.solver.max_iterations for t in steady)} ticks "
          f"at the {cfg.solver.max_iterations}-step cap; host syncs a tick "
          f"{statistics.mean(t[2] for t in steady):.1f} (min "
          f"{min(t[2] for t in steady)}, max {max(t[2] for t in steady)})",
          flush=True)
    if not cuda:
        return dict(launches=launches)
    if all(prof):
        busy = sum(p[0] for p in prof)
        wall3 = sum(p[2] for p in prof)
        print(f"[10] the last {n_prof} ticks under the profiler: "
              f"{sum(p[1] for p in prof)} device ops, device time "
              f"{busy:.2f} ms of {wall3:.1f} ms wall, so the card is idle "
              f"{100 * (1 - busy / wall3):.1f}% ({card})", flush=True)
    else:
        print(f"[10] the last {n_prof} ticks under the profiler: the "
              f"profiler lost the "
              f"events of {sum(not p for p in prof)} of them; device time "
              f"not measured", flush=True)

    # K1 on the session's own reduced system, against its plain version
    window, fams, losses = sm._build_device_problem()
    H, g, H_ll, g_l, W, _ = gn.assemble_normal_equations(window, fams,
                                                         losses)
    free = torch.cat([window.dense_free_mask(),
                      torch.zeros(1, dtype=torch.bool, device="cuda")])
    lm_free = window.landmarks.active & ~window.landmarks.held
    Hp, gp, _ = gn._damped_reduced_system(
        H, g, free, torch.tensor(cfg.solver.initial_lambda, device="cuda"),
        H_ll, g_l, W, lm_free)
    Hp, gp = Hp[None].contiguous(), gp[None].contiguous()
    x, _ = chol.cholesky_solve_batched(Hp, gp)
    x_ref, _ = chol.cholesky_solve_batched_reference(Hp, gp)
    torch.cuda.synchronize()
    sys_err = float((x - x_ref).abs().max())
    if Hp.shape[1:] != (1024, 1024) or not sys_err <= X_TOL * float(
            x_ref.abs().max()):
        raise RuntimeError(f"K1 on the session's reduced system "
                           f"{tuple(Hp.shape)}: err {sys_err}")
    k1_ms, plain_ms = _paired_ms(
        lambda: chol.cholesky_solve_batched(Hp, gp),
        lambda: chol.cholesky_solve_batched_reference(Hp, gp))
    bound = _chol_bound(1, 1024)
    print(f"[10] K1 on the session's reduced system {tuple(Hp.shape[1:])}: "
          f"max|x-x_ref|={sys_err:.3e} (bound "
          f"{X_TOL * float(x_ref.abs().max()):.3e}); kernel {k1_ms:.4f} ms, "
          f"plain (cholesky_ex + cholesky_solve) {plain_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}) (CUDA events, {card})", flush=True)

    # the same tick's problem on the card and on the CPU plain path
    opts = cfg.solver
    out, diag = gn.solve(window, fams, losses, opts)
    t_cpu = time.perf_counter()
    out_cpu, diag_cpu = gn.solve(window.to("cpu"),
                                 tuple(f.to("cpu") for f in fams), losses,
                                 opts)
    t_cpu = time.perf_counter() - t_cpu
    c1, c1_cpu = float(diag.final_cost), float(diag_cpu.final_cost)
    gap = abs(c1 - c1_cpu) / max(c1_cpu, 1e-30)
    dp = float((out.imu.p.cpu() - out_cpu.imu.p).abs().max())
    print(f"[10] one tick's problem, card vs CPU plain path: final cost "
          f"{c1:.6g} / {c1_cpu:.6g} (rel gap {gap:.2e}, bound {COST_RTOL}), "
          f"max|dp| {dp:.2e} m (bound {DP_TOL}), accepted steps "
          f"{int(diag.iterations)} / {int(diag_cpu.iterations)}; the CPU "
          f"solve {t_cpu:.1f} s", flush=True)
    if not (gap <= COST_RTOL and dp <= DP_TOL):
        raise RuntimeError("session tick on the card disagrees with the CPU "
                           "plain path")
    # the same problem with early exit off and on
    for early in (False, True):
        o = opts._replace(early_exit=early)
        n0 = chol.cholesky_solve_batched.launches
        ms = _wall_ms(lambda: gn.solve(window, fams, losses, o), 1)
        steps = chol.cholesky_solve_batched.launches - n0
        _, d = gn.solve(window, fams, losses, o)
        print(f"[10] one tick's problem, early_exit={early}: {ms:.1f} ms, "
              f"{steps} LM steps, final cost {float(d.final_cost):.6g}, "
              f"accepted {int(d.iterations)} ({card})", flush=True)
    return dict(launches=launches, k1_ms=k1_ms, plain_ms=plain_ms,
                bound=bound, err=sys_err)


def _overlap_s(span, intervals):
    return sum(max(0.0, min(span[1], b) - max(span[0], a))
               for a, b in intervals)


def _mapper_config(mode):
    """LocalMapperConfig.from_yaml of the mode's pipeline YAML, everything
    as it stands but the calibration: pipeline/sim_session's rig (its lidar
    extrinsic, and its camera and camera extrinsic where the mode has a
    camera)."""
    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
    cfg = LocalMapperConfig.from_yaml(
        str(ROOT / "configs" / MAPPER_YAML[mode]))
    cal = dict(q_baselink_lidar=tss.Q_BL, p_baselink_lidar=tss.P_BL)
    if mode != "LIO":
        cal.update(camera=tss.CAM, q_baselink_cam=tss.Q_BC,
                   p_baselink_cam=tss.P_BC, camera_hz=CAM_HZ)
    cfg.calibration = dataclasses.replace(cfg.calibration, **cal)
    return cfg


def _through_sensor_log(events, grids, device, card=""):
    """Phase 14c, inside phase 11: the session's IMU samples and scans
    (``grids``, stamp → RingGrid) written to a sensor log in a temporary
    directory and read back (pipeline/sensor_log: the host C++ library's
    index, held equal to the numpy index; scans decoded on ``device``).
    Every record must equal its event, and imu_batch the IMU samples.
    Returns the events with the decoded records in their place (``grids``
    updated in place), which phase 11's frame loop then runs on."""
    from beam_slam_tpu_torch.ops import native
    from beam_slam_tpu_torch.pipeline import sensor_log as slog
    cuda = device is None

    def sync():
        if cuda:
            torch.cuda.synchronize()
    if not native.native_available():
        raise RuntimeError("[14c] no g++ on PATH: the log's native index "
                           "cannot be built")
    kept = [ev for ev in events if ev[0] in ("imu", "scan")]
    imu_ev = [ev for ev in kept if ev[0] == "imu"]
    write_ms, read_ms, records = [], [], []
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "session.bslg")
        with slog.SensorLogWriter(path) as w:
            for ev in kept:
                if ev[0] == "imu":
                    w.add_imu(ev[1], ev[2], ev[3])
                    continue
                sync()
                t0 = time.perf_counter()
                w.add_scan(ev[1], grids[ev[1]])
                write_ms.append(1e3 * (time.perf_counter() - t0))
        size = Path(path).stat().st_size
        index = slog.index_log(path)
        for a, b in zip(index[:4], slog.index_log_numpy(index[4])):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise RuntimeError("[14c] the native index differs from the "
                                   "numpy index")
        reader = slog.read_log(path, device)
        while True:
            t0 = time.perf_counter()
            rec = next(reader, None)
            if rec is None:
                break
            if rec[0] == slog.T_SCAN:
                sync()
                read_ms.append(1e3 * (time.perf_counter() - t0))
            records.append(rec)
        t_b, w_b, a_b = slog.imu_batch(path)
    if len(records) != len(kept):
        raise RuntimeError(f"[14c] {len(records)} records for {len(kept)} "
                           f"events")
    out, it = [], iter(records)
    for ev in events:
        if ev[0] not in ("imu", "scan"):
            out.append(ev)
            continue
        rtype, stamp, payload = next(it)
        kind = {slog.T_IMU: "imu", slog.T_SCAN: "scan"}.get(rtype)
        if (kind, stamp) != (ev[0], ev[1]):
            raise RuntimeError(f"[14c] record {(rtype, stamp)} for event "
                               f"{ev[:2]}")
        if kind == "imu":
            if not (np.array_equal(payload[0], ev[2])
                    and np.array_equal(payload[1], ev[3])):
                raise RuntimeError(f"[14c] IMU record at {stamp} differs")
            out.append(("imu", stamp, *payload))
            continue
        g = grids[stamp]
        if not all(torch.equal(getattr(payload, f), getattr(g, f))
                   for f in ("xyz", "time", "valid")):
            raise RuntimeError(f"[14c] scan record at {stamp} differs")
        grids[stamp] = payload
        out.append(("scan", stamp, payload))
    if not (np.array_equal(t_b, [ev[1] for ev in imu_ev])
            and np.array_equal(w_b, np.stack([ev[2] for ev in imu_ev]))
            and np.array_equal(a_b, np.stack([ev[3] for ev in imu_ev]))):
        raise RuntimeError("[14c] imu_batch differs from the IMU samples")
    print(f"[14c] the session through a sensor log: {len(imu_ev)} IMU "
          f"samples and {len(write_ms)} scans, {size / 2 ** 20:.1f} MiB; "
          f"read back through the native index (equal to the numpy "
          f"index), every record equal to its event, imu_batch equal; "
          f"a scan written in {statistics.median(write_ms):.2f} ms and read "
          f"in {statistics.median(read_ms):.2f} ms (median, host clock, the "
          f"card synced; {card}); the frame loop below runs on the decoded "
          f"records", flush=True)
    return out


def _mapper_frames(mode, duration_s, dev, card="", through_log=True):
    """The events of phases 11, 12a and 12c: the mode's config (VIO
    ignites after VIO_INIT_M), pipeline/sim_session's events (LIO's scans
    the vendored scan seen from each scan's lidar pose; with
    ``through_log`` its IMU samples and scans through a sensor log and
    back, 14c), cut into frames (a frame: its IMU samples, sensors and
    tick). Returns (config, frames, grids by stamp, scan stamps, ground
    truth by sensor stamp)."""
    from beam_slam_tpu_torch import device as tdev
    from beam_slam_tpu_torch.core import lie_np
    from beam_slam_tpu_torch.pipeline import sim_session as tss
    cfg = _mapper_config(mode)
    if mode == "VIO":
        cfg.init.min_trajectory_length_m = VIO_INIT_M
    traj, events, _ = tss.generate_session_events(
        mode=mode, duration_s=duration_s, imu_hz=IMU_RATE, cam_hz=CAM_HZ,
        lidar_hz=MAPPER_LIDAR_HZ, seed=MAPPER_SEED, device=dev)
    scan_t = [ev[1] for ev in events if ev[0] == "scan"]
    sensor_t = sorted({ev[1] for ev in events if ev[0] in ("scan", "pose")}
                      | {ev[1].stamp for ev in events if ev[0] == "cam"})
    gt = traj.sample(torch.tensor(sensor_t, dtype=torch.float32,
                                  device=traj.device))
    gt_q, gt_p = tdev.to_numpy(gt.q, gt.p)
    gt_at = {t: (gt_q[i], gt_p[i]) for i, t in enumerate(sensor_t)}
    grids = {ev[1]: ev[2] for ev in events if ev[0] == "scan"}
    if mode == "LIO":   # the vendored scan
        cloud = _load_scan()
        for t in scan_t:
            q_wl = lie_np.quat_mul(gt_at[t][0], tss.Q_BL)
            p_wl = gt_at[t][1] + lie_np.quat_rotate(gt_at[t][0], tss.P_BL)
            grids[t] = _observed_grid(cloud, q_wl, p_wl, dev)
        if through_log:   # 14c: the session's IMU and scans through the log
            events = _through_sensor_log(events, grids, dev, card)
    frames, cur = [], []
    for ev in events:   # one frame: its IMU samples, sensors and tick
        cur.append(ev)
        if ev[0] == "tick":
            frames.append(cur)
            cur = []
    return cfg, frames, grids, scan_t, gt_at


def run_mapper(card="", device="cuda", duration_s=MAPPER_S, mode="LIO",
               tag="11"):
    """Phases 11, 12a and 12c: the LocalMapper of the mode's pipeline YAML
    (configs/lio.yaml, lvio.yaml or vio.yaml as they stand, with the sim's
    rig; the default async tick) fed pipeline/sim_session's events, every
    LIO scan the vendored VLP-16 scan seen from that scan's lidar pose at
    16 × 1800 (LVIO's: the session's own structured 16 × 504 scene), the
    camera's tracked landmarks at 20 Hz. LIO and LVIO run SLAM
    initialization in LIDAR mode, lidar odometry (K2 in every
    registration), gravity alignment and inertial odometry; LVIO and VIO
    add visual odometry; VIO ignites from the camera's SfM path (VISUAL)
    after VIO_INIT_M of path. K1 runs in every LM step of every solve (the
    worker's), the ignition's included. Returns the launch counts.
    ``device="cpu"`` (and a shorter ``duration_s``) rehearses the phase off
    the card: no profiler, no kernel comparison."""
    from beam_slam_tpu_torch import device as tdev
    from beam_slam_tpu_torch.core import lie_np
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.solver import smoother as tsm
    from beam_slam_tpu_torch.tools.run_ate_benchmark import union_ms
    from beam_slam_tpu_torch.utils.evaluation import ate_rmse

    cuda = device == "cuda"
    dev = None if cuda else device   # entry points: None is the card
    lidar, camera = mode in ("LIO", "LVIO"), mode in ("LVIO", "VIO")

    def main_sync():   # the caller's stream only: the worker's runs on
        if cuda:
            torch.cuda.current_stream().synchronize()

    cfg, frames, grids, scan_t, gt_at = _mapper_frames(
        mode, duration_s, dev, card)
    vendored = mode == "LIO"

    mapper = LocalMapper(cfg, device=dev)
    sm = mapper.smoother
    harvests = []
    harvest_fn = sm._harvest

    def counted_harvest():
        job = sm._inflight
        diag = harvest_fn()
        harvests.append(dict(job=job, span=sm.last_solve_span,
                             c0=float(diag.initial_cost),
                             c1=float(diag.final_cost),
                             accepted=int(diag.iterations),
                             k1=chol.cholesky_solve_batched.launches))
        return diag
    sm._harvest = counted_harvest
    # the problem of every dispatched solve, as the worker gets it: the last
    # one is held card vs CPU after the session
    problems, job_cls = [], tsm._AsyncSolve

    class RecordedSolve(job_cls):
        def __init__(self, window, families, losses, options, *rest):
            problems[:] = [(window, families, losses, options)]
            super().__init__(window, families, losses, options, *rest)
    tsm._AsyncSolve = RecordedSolve

    # host waits by thread: the sync debug mode's warnings (reads of a
    # device value) and the event waits of HostCopy
    syncs = collections.Counter()
    numpy_fn = tdev.HostCopy.numpy

    def counted_numpy(self):
        if self._event is not None:
            syncs[threading.current_thread() is threading.main_thread()] += 1
        return numpy_fn(self)

    def on_warning(message, *args, **kwargs):
        if "synchroniz" in str(message):
            syncs[threading.current_thread() is threading.main_thread()] += 1

    # The newest state of each tick is, with the async tick, the IMU's
    # prediction: its solve lands a tick later. The state a harvested solve
    # brought back for the newest stamp it covered is the mapper's solved
    # estimate of that stamp.
    est_solved, dispatched = {}, [None]

    def record_solved(n_before):
        t = dispatched[0]
        if len(harvests) > n_before and t is not None:
            st = sm.try_get_state(t)
            if st is not None:
                est_solved[t] = st["p"].copy()
        dispatched[0] = (sm.current_stamps()[-1]
                         if sm._inflight is not None else None)

    def on_event(ev):
        """Feed one sensor event; its wall ms (the caller's stream synced)
        for the scans and camera frames, and whether it made a keyframe."""
        kind = ev[0]
        if kind == "imu":
            mapper.on_imu(ev[1], ev[2], ev[3])
            return None, False
        if kind == "pose":
            mapper.on_pose(ev[1], ev[2], ev[3])
            return None, False
        t0 = time.perf_counter()
        kf = (mapper.on_scan(ev[1], grids[ev[1]]) if kind == "scan"
              else mapper.on_camera_measurement(ev[1]))
        main_sync()
        return 1e3 * (time.perf_counter() - t0), kf

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof, prof_wall = None, None
    rows, est, ign, n_harvests, vo_kf = [], {}, None, 0, 0
    chol.cholesky_solve_batched.launches = 0
    knn.knn_topk.launches = 0
    tdev.HostCopy.numpy = counted_numpy
    t_run = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        if cuda:
            torch.cuda.set_sync_debug_mode(1)
        try:
            for i, frame in enumerate(frames):
                if cuda and i == len(frames) - MAPPER_PROFILED:
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                    prof_wall = time.perf_counter()
                was = mapper.initialized
                s0 = dict(syncs)
                k2_0 = knn.knn_topk.launches
                t0 = time.perf_counter()
                ms = {}
                for ev in frame[:-1]:
                    ms_ev, kf = on_event(ev)
                    if ms_ev is not None:
                        ms[ev[0]] = ms_ev
                        vo_kf += int(was and ev[0] == "cam" and kf)
                        if not was and mapper.initialized and ign is None:
                            ign = dict(kind=ev[0], ms=ms_ev,
                                       wall=time.perf_counter() - t_run)
                t1 = time.perf_counter()
                mapper.tick()
                main_sync()
                t3 = time.perf_counter()
                if ign is not None and "frames" not in ign:
                    ign.update(stamp=mapper.init.result["stamp"],
                               k1=chol.cholesky_solve_batched.launches,
                               k2=knn.knn_topk.launches, frames=i + 1)
                if was:
                    rows.append(dict(
                        ingest=(t0, t1), scan_ms=ms.get("scan"),
                        cam_ms=ms.get("cam"), tick_ms=1e3 * (t3 - t1),
                        k2=knn.knn_topk.launches - k2_0,
                        main_syncs=syncs[True] - s0.get(True, 0),
                        worker_syncs=syncs[False] - s0.get(False, 0)))
                if mapper.initialized and sm.current_stamps():
                    newest = sm.current_stamps()[-1]
                    est[newest] = sm.get_state(newest)["p"].copy()
                    record_solved(n_harvests)
                n_harvests = len(harvests)
            if prof is not None:
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - prof_wall
                prof.__exit__(None, None, None)
            mapper.flush()
            main_sync()
            record_solved(n_harvests)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            tdev.HostCopy.numpy = numpy_fn
            sm._harvest = harvest_fn
            tsm._AsyncSolve = job_cls
    wall = time.perf_counter() - t_run
    launches = dict(k1=chol.cholesky_solve_batched.launches,
                    k2=knn.knn_topk.launches)

    # checks
    if ign is None or not mapper.initialized:
        raise RuntimeError(f"[{tag}] the mapper never initialized")
    # the mapper's world frame is its first pose's, turned to gravity: hold
    # the window against ground truth after the rigid transform that fits
    # the window's poses best (the chordal mean of the rotation offsets,
    # then the translation of the centroids)
    stamps = sm.current_stamps()
    states = [sm.get_state(t) for t in stamps]
    R_est = lie_np.quat_to_matrix(np.stack([st["q"] for st in states]))
    R_gt = lie_np.quat_to_matrix(np.stack([gt_at[t][0] for t in stamps]))
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", R_gt, R_est))
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    p_est = np.stack([st["p"] for st in states]).astype(np.float64)
    tr = np.mean(np.stack([gt_at[t][1] for t in stamps]) - p_est @ R.T, 0)
    q_align = lie_np.matrix_to_quat(R.astype(np.float32))
    errs = {t: (float(np.linalg.norm(R @ st["p"] + tr - gt_at[t][1])),
                _so3_err(lie_np.quat_mul(q_align, st["q"]), gt_at[t][0]))
            for t, st in zip(stamps, states)}
    worst = tuple(max(e[i] for e in errs.values()) for i in (0, 1))
    t_worst = max(errs, key=lambda t: errs[t][0])
    def newest_ate(e):
        ts = sorted(e)
        return ate_rmse(np.stack([e[t] for t in ts]),
                        np.stack([gt_at[t][1] for t in ts]))
    ate, ate_stale = newest_ate(est_solved), newest_ate(est)
    c = sm.counters
    jobs = [id(h["job"]) for h in harvests]   # each job is held: ids unique
    bad = [h for h in harvests
           if not (np.isfinite(h["c1"]) and h["c1"] <= h["c0"])]
    n_lm, n_reproj = int(sm.lm_active.sum()), int(sm.arena_reproj.active.sum())
    n_rel = int(sm.arena_rel.active.sum())
    reg = type(mapper.lo.registration).__name__ if lidar else "none"
    unscaled = (", not held without lidar: the scale is the SfM path's "
                "times the inertial alignment's")
    sensors = " / ".join(
        [f"{IMU_RATE:.0f} Hz IMU"]
        + ([f"{CAM_HZ:.0f} Hz camera"] if camera else [])
        + ([f"{MAPPER_LIDAR_HZ:.0f} Hz lidar"] if lidar else []))
    scan_src = (f"the vendored scan at {N_RINGS} × {WIDTH}"
                if vendored else "the session's 16 × 504 scene")
    print(f"[{tag}] {mode} LocalMapper, configs/{MAPPER_YAML[mode]} "
          f"({cfg.max_states} states, lag {cfg.lag_duration} s, LM <= "
          f"{cfg.max_iterations} steps with early exit, async tick, "
          f"{cfg.init.mode} initialization at "
          f"{cfg.init.min_trajectory_length_m} m, registration {reg}, "
          f"{len(mapper.lo.input_filters) if lidar else 0} input filters, "
          f"{cfg.max_landmarks} landmarks, {sm.arena_reproj.capacity} "
          f"reprojection factors), {duration_s} s of events at {sensors}"
          f"{', ' + scan_src if lidar else ''}: "
          f"ignition at {ign['stamp']} s after {ign['frames']} frames "
          f"({ign['wall']:.1f} s of wall, the igniting {ign['kind']} "
          f"{ign['ms']:.1f} ms); after the flush {len(stamps)} states, "
          f"{stamps[0]}–{stamps[-1]} s, worst {worst[0]:.4f} m (at "
          f"{t_worst} s) / {worst[1]:.4f} rad off ground truth "
          f"(after the best rigid fit of the window's poses; bounds "
          f"{GT_TRANS} / {GT_ROT}{'' if lidar else unscaled}); "
          f"ATE of the newest solved states {ate:.4f} m over "
          f"{len(est_solved)} solves (bound "
          f"{GT_TRANS if lidar else 'none'}), of each tick's newest state "
          f"(one solve stale) {ate_stale:.4f} m; counters {c}; "
          f"{len(harvests)} solves harvested of {sm.solve_count} "
          f"dispatched, {len(bad)} with a final cost above the initial; "
          f"at the end {n_lm} landmarks, {n_reproj} reprojection and "
          f"{n_rel} relative-pose factors active; {vo_kf} VO keyframes",
          flush=True)
    if not (c["dropped_transactions"] == 0 and not bad
            and len(set(jobs)) == len(jobs) == sm.solve_count):
        raise RuntimeError(f"[{tag}] mapper session failed its checks")
    if lidar and not (worst[0] < GT_TRANS and worst[1] < GT_ROT
                                 and ate < GT_TRANS):
        raise RuntimeError(f"[{tag}] mapper session off ground truth")
    if camera and not (vo_kf > 0 and n_lm > 0 and n_reproj > 0):
        raise RuntimeError(f"[{tag}] visual odometry made no map")
    if mode == "LVIO" and not n_rel > 0:
        raise RuntimeError(f"[{tag}] no lidar factor at the end")
    if mode == "VIO" and not (cfg.init.mode == "VISUAL"
                              and mapper.init.result["scale"] != 1.0):
        raise RuntimeError(f"[{tag}] the ignition did not come through SfM")
    if cuda and not (launches["k1"] >= sm.solve_count
                     and launches["k2"] >= 2 * len(scan_t) - 2):
        raise RuntimeError(f"[{tag}] launches {launches}")

    steps = [b["k1"] - a["k1"] for a, b in zip(harvests, harvests[1:])]
    spans = [h["span"] for h in harvests[1:]]   # after the ignition solve
    ingest = [r["ingest"] for r in rows]
    solve_s = sum(b - a for a, b in spans)
    shared = sum(_overlap_s(sp, ingest) for sp in spans)

    def spread(xs, fmt=".1f"):
        xs = [x for x in xs if x is not None] or [0]
        return (f"median {statistics.median(xs):{fmt}} (min {min(xs):{fmt}},"
                f" max {max(xs):{fmt}})")
    print(f"[{tag}] per tick after ignition ({len(rows)} frames, {card}): "
          + (f"ingestion (on_scan) ms {spread([r['scan_ms'] for r in rows])}"
             "; " if lidar else "")
          + (f"on_camera_measurement ms "
             f"{spread([r['cam_ms'] for r in rows])}; " if camera else "")
          + f"tick() ms {spread([r['tick_ms'] for r in rows])}; solve on "
          f"the worker ms {spread([1e3 * (b - a) for a, b in spans])}; "
          f"{100 * shared / max(solve_s, 1e-9):.1f}% of the solve wall "
          f"overlapped ingestion; LM steps run a solve "
          f"{spread(steps)} (K1 launches), accepted "
          f"{spread([h['accepted'] for h in harvests])}; K2 launches a "
          f"frame {spread([r['k2'] for r in rows])}; host syncs a frame: "
          f"main thread {spread([r['main_syncs'] for r in rows])}, worker "
          f"{spread([r['worker_syncs'] for r in rows])}; during "
          f"initialization K1 {ign['k1']} and K2 {ign['k2']} launches, in "
          f"the whole phase K1 {launches['k1']} and K2 {launches['k2']}; "
          f"forced marginalizations "
          f"{c['forced_state_marginalizations']}, landmark evictions "
          f"{c['landmark_evictions']}; wall {wall:.1f} s for {duration_s} s "
          f"of sensor time, real-time factor (wall / sensor time) "
          f"{wall / duration_s:.2f}", flush=True)
    if not cuda:
        return dict(launches=launches)
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if any("chol_solve" in e.name for e in on_dev):
        busy = union_ms([(e.time_range.start, e.time_range.end)
                         for e in on_dev])
        print(f"[{tag}] the last {MAPPER_PROFILED} frames under the "
              f"profiler: {len(on_dev)} device ops, device time {busy:.2f} "
              f"ms of {1e3 * prof_wall:.1f} ms wall (the union over both "
              f"streams), so the card is idle "
              f"{100 * (1 - busy / (1e3 * prof_wall)):.1f}% ({card})",
              flush=True)
    else:
        print(f"[{tag}] the last {MAPPER_PROFILED} frames under the "
              f"profiler: the profiler saw no K1 event in them; device "
              f"time not measured", flush=True)

    # K1 on the mapper's own reduced system, against its plain version: the
    # last problem the mapper dispatched, as the worker got it (unsolved)
    window, fams, losses, opts = problems[-1]
    H, g, H_ll, g_l, W, _ = gn.assemble_normal_equations(window, fams,
                                                         losses)
    free = torch.cat([window.dense_free_mask(),
                      torch.zeros(1, dtype=torch.bool, device="cuda")])
    lm_free = window.landmarks.active & ~window.landmarks.held
    Hp, gp, _ = gn._damped_reduced_system(
        H, g, free, torch.tensor(opts.initial_lambda, device="cuda"),
        H_ll, g_l, W, lm_free)
    Hp, gp = Hp[None].contiguous(), gp[None].contiguous()
    x, _ = chol.cholesky_solve_batched(Hp, gp)
    x_ref, _ = chol.cholesky_solve_batched_reference(Hp, gp)
    torch.cuda.synchronize()
    sys_err = float((x - x_ref).abs().max())
    # that problem solved on the card and on the CPU plain path, with the
    # mapper's own solver options; VIO's solved to convergence
    solved = mode == "VIO"
    if solved:
        opts = opts._replace(max_iterations=SOLVED_LM_STEPS, early_exit=True)
    out, diag = gn.solve(window, fams, losses, opts)
    t_cpu = time.perf_counter()
    out_cpu, diag_cpu = gn.solve(window.to("cpu"),
                                 tuple(f.to("cpu") for f in fams), losses,
                                 opts)
    t_cpu = time.perf_counter() - t_cpu
    c1, c1_cpu = float(diag.final_cost), float(diag_cpu.final_cost)
    gap = _rel_gap(c1, c1_cpu)
    dp = float((out.imu.p.cpu() - out_cpu.imu.p).abs().max())
    print(f"[{tag}] K1 on the mapper's reduced system "
          f"{tuple(Hp.shape[1:])} ({int(window.landmarks.active.sum())} "
          f"landmarks eliminated): max|x-x_ref|={sys_err:.3e} (bound "
          f"{X_TOL * float(x_ref.abs().max()):.3e}); the last problem it "
          f"dispatched (LM <= {opts.max_iterations} steps, early exit "
          f"{opts.early_exit}), card vs CPU plain path: cost "
          f"{float(diag.initial_cost):.6g} -> {c1:.6g} / {c1_cpu:.6g}, "
          f"accepted steps "
          f"{int(diag.iterations)} / {int(diag_cpu.iterations)} (rel gap "
          + (f"{gap:.2e}, not held: two float32 solves; under the float64 "
             f"evaluator "
             f"{_rel_gap(*_cost64((out, out_cpu), fams, losses)):.2e})"
             if solved else f"{gap:.2e}, bound {COST_RTOL})")
          + f", max|dp| {dp:.2e} m (bound {DP_TOL}); the CPU solve "
          f"{t_cpu:.1f} s", flush=True)
    if Hp.shape[1:] != (1024, 1024) or not sys_err <= X_TOL * float(
            x_ref.abs().max()):
        raise RuntimeError(f"[{tag}] K1 on the mapper's reduced system "
                           f"disagrees")
    if solved:
        gaps, dps, ms = _lockstep_card_vs_cpu(window, fams, losses, opts)
        print(f"[{tag}] the same problem, each of the card's {len(gaps)} LM "
              f"steps to convergence also taken on the CPU plain path from "
              f"the card's state: trial costs (float64 evaluator) worst rel "
              f"gap {max(gaps):.2e} (bound {COST_RTOL}), trial positions "
              f"worst max|dp| {max(dps):.2e} m (bound {DP_TOL}); "
              f"{ms:.0f} ms a step", flush=True)
        cost_ok = all(x <= COST_RTOL for x in gaps) and all(
            x <= DP_TOL for x in dps)
        # are the two independent end states minima? The float64 gradient
        # at each (against the unsolved problem's) and the float64 cost
        # along the segment from the CPU's end state to the card's
        alphas = (0.0, 0.25, 0.5, 0.75, 1.0)
        grads = [_grad64(w, fams, losses) for w in (window, out, out_cpu)]
        seg = _cost64([_lerp_window(out_cpu, out, a) for a in alphas],
                      fams, losses)
        print(f"[{tag}] the independent end states: float64 gradient norm "
              f"card {grads[1]:.3e}, CPU {grads[2]:.3e} (the unsolved "
              f"problem's {grads[0]:.3e}); float64 cost at α = "
              f"{', '.join(map(str, alphas))} from the CPU's end state to "
              f"the card's: {', '.join(f'{x:.10g}' for x in seg)} (rel to "
              f"the lower end: "
              f"{', '.join(f'{x / min(seg[0], seg[-1]) - 1:+.2e}' for x in seg)})",
              flush=True)
    else:
        cost_ok = gap <= COST_RTOL
    if not (cost_ok and dp <= DP_TOL):
        raise RuntimeError(f"[{tag}] the mapper's problem on the card "
                           f"disagrees with the CPU plain path")
    return dict(launches=launches, frames=frames, grids=grids)


def _cost64(windows, fams, losses):
    """The problem's cost at each window under one evaluator, the CPU plain
    path in float64 (the float32 states cast up)."""
    from beam_slam_tpu_torch.solver import gauss_newton as gn

    def f64(s):
        return s.map(lambda t: t.double() if t.is_floating_point() else t)
    fams64 = tuple(f64(f.to("cpu")) for f in fams)
    return [float(gn.total_cost(f64(w.to("cpu")), fams64, losses))
            for w in windows]


def _f64(s):
    return s.map(lambda t: t.double() if t.is_floating_point() else t)


def _grad64(window, fams, losses) -> float:
    """Norm of the problem's gradient over its free dof (dense and
    landmark) at ``window``, the CPU plain path in float64."""
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    w = _f64(window.to("cpu"))
    _, g, _, g_l, _, _ = gn.assemble_normal_equations(
        w, tuple(_f64(f.to("cpu")) for f in fams), losses)
    free = w.dense_free_mask().double()
    lm_free = (w.landmarks.active & ~w.landmarks.held).double()
    return float(torch.sqrt(torch.sum((g[:-1] * free) ** 2)
                            + torch.sum((g_l * lm_free[:, None]) ** 2)))


def _lerp_window(a, b, alpha):
    """a + α·(b − a) leafwise in float64 on the CPU, quaternions
    renormalized; masks from ``a``."""
    from beam_slam_tpu_torch.core import lie
    w = _f64(a.to("cpu")).map(
        lambda x, y: x + alpha * (y - x) if x.is_floating_point() else x,
        _f64(b.to("cpu")))
    return w.replace(
        imu=w.imu.replace(q=lie.quat_normalize(w.imu.q)),
        extrinsics=w.extrinsics.replace(
            q=lie.quat_normalize(w.extrinsics.q)))


def _rel_gap(c, c_ref):
    return abs(c - c_ref) / max(c_ref, 1e-30)


def _lockstep_card_vs_cpu(window, fams, losses, opts):
    """The problem solved on the card under ``opts`` (LM with early exit),
    each step also taken on the CPU plain path from the card's state and λ.
    Returns, per step, the relative gap of the two trial states' costs under
    _cost64 and their largest position gap (m), and the ms per step."""
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    fams_cpu = tuple(f.to("cpu") for f in fams)

    def step(w, fs, lam):   # one LM step; also returns its trial state
        seen = []

        def assemble(x):
            seen.append(x)
            return gn.assemble_normal_equations(x, fs, losses)
        out, diag = gn.lm_loop(w, assemble, 1,
                               opts._replace(initial_lambda=lam))
        return out, diag, seen[1]
    lam, gaps, dps = opts.initial_lambda, [], []
    t0 = time.perf_counter()
    for _ in range(opts.max_iterations):
        out, diag, trial = step(window, fams, lam)
        _, _, trial_cpu = step(window.to("cpu"), fams_cpu, lam)
        gaps.append(_rel_gap(*_cost64((trial, trial_cpu), fams, losses)))
        dps.append(float((trial.imu.p.cpu() - trial_cpu.imu.p).abs().max()))
        window, lam = out, float(diag.final_lambda)
        if bool(diag.converged):
            break
    return gaps, dps, 1e3 * (time.perf_counter() - t0) / len(gaps)


def _texture(rng, H, W, n_blobs):
    """tests/test_torch_vision.py's blob texture at a camera's size."""
    img = np.zeros((H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x, a in zip(rng.uniform(10, H - 10, n_blobs),
                       rng.uniform(10, W - 10, n_blobs),
                       rng.uniform(60, 200, n_blobs)):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 2.5 ** 2))
    return np.clip(img, 0, 255).astype(np.float32)


def run_front_end(card="", device="cuda"):
    """Phase 12b: the feature tracker of configs/lvio.yaml's vo/ JSON tier
    (FAST-9 at threshold 20 with a 32-px grid, LK 21 px × 4 levels × 30
    steps) on the card and on the CPU, over a seeded integer-valued
    640 × 480 texture moving by known subpixel steps: detection equal, the
    same ids, the tracks within FRONT_END_PX; ms per process_image.
    ``device="cpu"`` rehearses the phase off the card (CPU against CPU)."""
    from scipy import ndimage

    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.vision import detector as det
    cfg = _mapper_config("LVIO")
    trackers = [cfg.build_tracker(tss.CAM, device=d)
                for d in (None if device == "cuda" else device, "cpu")]
    base = _texture(np.random.default_rng(FRONT_END_SEED), tss.CAM.height,
                    tss.CAM.width, 600)
    frames = [np.round(ndimage.shift(base, (k * FRONT_END_STEP[0],
                                            k * FRONT_END_STEP[1]),
                                     order=1, mode="nearest"))
              .astype(np.float32) for k in range(FRONT_END_FRAMES)]
    outs = [det.detect(torch.as_tensor(frames[0], device=d),
                       trackers[0].fast_cfg) for d in (device, "cpu")]
    for a, b in zip(*outs):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError("[12b] FAST detection differs on the card")
    worst, ms, n_ids = 0.0, [], []
    for k, img in enumerate(frames):
        t0 = time.perf_counter()
        mc = trackers[0].process_image(0.05 * k, img)   # returns host data
        ms.append(1e3 * (time.perf_counter() - t0))
        mp = trackers[1].process_image(0.05 * k, img)
        if not np.array_equal(mc.ids, mp.ids):
            raise RuntimeError(f"[12b] frame {k}: the ids differ")
        if len(mc.ids):
            worst = max(worst, float(np.abs(mc.pixels - mp.pixels).max()))
        n_ids.append(len(mc.ids))
    print(f"[12b] the feature tracker of configs/lvio.yaml "
          f"(FAST threshold {trackers[0].fast_cfg.threshold}, LK "
          f"{trackers[0].lk_cfg.window} px × {trackers[0].lk_cfg.levels} "
          f"levels × {trackers[0].lk_cfg.iterations} steps) on "
          f"{FRONT_END_FRAMES} frames of {tss.CAM.width}×{tss.CAM.height}, "
          f"card vs CPU: detection equal, ids equal ({min(n_ids)}–"
          f"{max(n_ids)} features a frame), max|Δpixel| {worst:.2e} px "
          f"(bound {FRONT_END_PX}); process_image on the card ms "
          f"median {statistics.median(ms[1:]):.1f} (min {min(ms[1:]):.1f}, "
          f"max {max(ms[1:]):.1f}; the first, with the detection only, "
          f"{ms[0]:.1f}) ({card})", flush=True)
    if not worst <= FRONT_END_PX:
        raise RuntimeError(f"[12b] tracks differ by {worst} px")


def run_vision(card=""):
    """Phase 12: the LVIO mapper (12a), the image front end (12b) and VIO
    with VISUAL initialization (12c). Returns the launch counts."""
    lvio = run_mapper(card, duration_s=LVIO_S, mode="LVIO", tag="12a")
    run_front_end(card)
    vio = run_mapper(card, duration_s=VIO_S, mode="VIO", tag="12c")
    return dict(launches={k: lvio["launches"][k] + vio["launches"][k]
                          for k in ("k1", "k2")})


# Phase 13's environment, ray-cast from every chunk's pose: a hall of
# 32 m × 20 m (walls at x = ±16, y = ±10), floor at -1.8 m and ceiling at
# +3.0 m about the sensor, and pillars of radius 0.25 m off the path,
# placed without symmetry; range noise 5 mm (numpy seed: the chunk index).
HALL = dict(x=16.0, y=10.0, floor=1.8, ceiling=3.0, radius=0.25,
            pillars=((-13.0, -7.5), (-6.5, -7.0), (1.5, -8.0), (9.0, -6.5),
                     (14.0, -2.0), (12.5, 7.5), (4.0, 6.5), (-3.5, 8.0),
                     (-12.0, 6.0), (-14.5, 0.5), (-2.0, 0.5), (6.0, -1.0)),
            noise=0.005)


def _hall_grid(q, p, device, width=WIDTH, seed=0):
    """A VLP-16 at pose (q, p) in the HALL: 16 rings from -15° to 15° ×
    ``width`` azimuths, each beam's first hit (exact ray casting), its range
    with seeded noise; the points in the sensor frame as a RingGrid on
    ``device``. Every pose samples the surfaces anew, as a real scan does
    (the vendored scan seen from another pose holds the same points)."""
    from beam_slam_tpu_torch.core import lie_np
    from beam_slam_tpu_torch.device import resolve, to_device_many
    from beam_slam_tpu_torch.lidar.cloud import RingGrid
    az = np.linspace(-np.pi, np.pi, width, endpoint=False)
    el = np.deg2rad(np.linspace(-15.0, 15.0, N_RINGS))
    d_s = np.stack(np.broadcast_arrays(
        np.cos(el)[:, None] * np.cos(az)[None, :],
        np.cos(el)[:, None] * np.sin(az)[None, :],
        np.sin(el)[:, None] * np.ones_like(az)[None, :]), axis=-1)
    d = lie_np.quat_rotate(np.asarray(q, np.float64)[None, None], d_s)
    o = np.asarray(p, np.float64)
    t = np.full(d.shape[:2], np.inf)
    for axis, lo, hi in ((0, -HALL["x"], HALL["x"]), (1, -HALL["y"], HALL["y"]),
                         (2, o[2] - HALL["floor"], o[2] + HALL["ceiling"])):
        for c in (lo, hi):
            with np.errstate(divide="ignore", invalid="ignore"):
                tc = (c - o[axis]) / d[..., axis]
            t = np.where((tc > 0) & np.isfinite(tc), np.minimum(t, tc), t)
    r = HALL["radius"]
    for cx, cy in HALL["pillars"]:
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = 2 * (d[..., 0] * (o[0] - cx) + d[..., 1] * (o[1] - cy))
        c0 = (o[0] - cx) ** 2 + (o[1] - cy) ** 2 - r * r
        disc = b * b - 4 * a * c0
        with np.errstate(invalid="ignore", divide="ignore"):
            tc = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        t = np.where((disc > 0) & (tc > 0.1), np.minimum(t, tc), t)
    valid = np.isfinite(t) & (t < 100.0)
    t = t + np.random.default_rng(seed).standard_normal(t.shape) * \
        HALL["noise"]
    xyz = np.where(valid[..., None], d_s * t[..., None], 0.0)
    tgrid = np.broadcast_to(((az + np.pi) / (2 * np.pi) * 0.1)[None, :],
                            valid.shape)
    x, tg, v = to_device_many((xyz.astype(np.float32),
                               tgrid.astype(np.float32), valid),
                              resolve(device))
    return RingGrid(xyz=x, time=tg, valid=v)


def _loop_truth():
    """Phase 13's true poses: a chunk every metre counter-clockwise around
    GLOBAL_RECT from its first corner, the yaw along each side, then
    GLOBAL_EXTRA chunks past the start. Returns [(q, p)] (host)."""
    from beam_slam_tpu_torch.core import lie_np
    W, H = GLOBAL_RECT
    corners = [(0.0, 0.0), (W, 0.0), (W, H), (0.0, H)]
    path = []
    for c in range(4):
        (x0, y0), (x1, y1) = corners[c], corners[(c + 1) % 4]
        n = int(round(np.hypot(x1 - x0, y1 - y0)))
        path += [(x0 + (x1 - x0) * i / n, y0 + (y1 - y0) * i / n,
                  np.arctan2(y1 - y0, x1 - x0)) for i in range(n)]
    path += [(float(i), 0.0, 0.0) for i in range(GLOBAL_EXTRA + 1)]
    x0, y0 = GLOBAL_ORIGIN
    return [(lie_np.so3_exp_quat(np.array([0, 0, yaw], np.float32)),
             np.array([x0 + x, y0 + y, 0.0], np.float32))
            for x, y, yaw in path]


def _drifted(truth):
    """The odometry: each true pose moved by a rigid drift that grows
    linearly along the path, to GLOBAL_DRIFT (a yaw in degrees about the
    first pose, a shift in metres at the last; direction and sign from
    numpy seed GLOBAL_SEED), as dead reckoning drifts: the path stays
    locally rigid. Returns [(q, p)] and each pose's position error."""
    from beam_slam_tpu_torch.core import lie_np
    drift = GLOBAL_DRIFT
    rng = np.random.default_rng(GLOBAL_SEED)
    th = rng.uniform(0, 2 * np.pi)
    sign = rng.choice([-1.0, 1.0])
    p0 = truth[0][1]
    out, norms = [], []
    for k, (q, p) in enumerate(truth):
        f = k / (len(truth) - 1)
        dq = lie_np.so3_exp_quat(np.array(
            [0, 0, sign * np.deg2rad(drift[1]) * f], np.float32))
        p_o = (p0 + lie_np.quat_rotate(dq, p - p0) + drift[0] * f
               * np.array([np.cos(th), np.sin(th), 0.0])).astype(np.float32)
        out.append((lie_np.quat_mul(dq, q).astype(np.float32), p_o))
        norms.append(float(np.linalg.norm(p_o - p)))
    return out, norms


def _submap_on(sm, device):
    """A copy of a submap on another device (poses shared, features
    moved)."""
    from beam_slam_tpu_torch.global_mapping.submap import (LidarKeyframe,
                                                           Submap)
    out = Submap(sm.stamp, sm.q, sm.p, device=device)
    out.q_initial, out.p_initial = sm.q_initial, sm.p_initial
    out.lidar_keyframes = [LidarKeyframe(k.stamp, k.q, k.p,
                                         k.features.to(device))
                           for k in sm.lidar_keyframes]
    return out


class _Recorder:
    """Phase 13's instruments while it runs: every LM loop (steps run and
    accepted, costs, its K1 launches, the shape of its systems), every
    LOAM registration (its GN steps and fits), every submap-refinement
    batch solve's inputs, and a label (the stage) on each; restored by
    ``close``."""

    def __init__(self):
        from beam_slam_tpu_torch.lidar import registration as reg
        from beam_slam_tpu_torch.ops import cholesky as chol
        from beam_slam_tpu_torch.parallel import sharded
        from beam_slam_tpu_torch.solver import batched as bsv
        from beam_slam_tpu_torch.solver import gauss_newton as gn
        self.stage, self.solves, self.regs, self.batches = "", [], [], []
        self._saved = [(gn, "lm_loop", gn.lm_loop),
                       (reg, "register_loam", reg.register_loam),
                       (sharded, "solve_batched", sharded.solve_batched),
                       (bsv, "solve_batched_shared",
                        bsv.solve_batched_shared)]
        lm_loop, register = gn.lm_loop, reg.register_loam

        def lm(window, assemble, n_iter, options):
            k1 = chol.cholesky_solve_batched.launches
            out, d = lm_loop(window, assemble, n_iter, options)
            c0, c1, acc = (d.initial_cost.reshape(-1).tolist(),
                           d.final_cost.reshape(-1).tolist(),
                           d.iterations.reshape(-1).tolist())
            self.solves.append(dict(
                stage=self.stage, B=len(c0), N=window.num_dense_dof + 1,
                steps=chol.cholesky_solve_batched.launches - k1,
                n_iter=n_iter, accepted=acc, c0=c0, c1=c1))
            return out, d

        def registration(scan, *a, **k):
            cfg = a[6] if len(a) > 6 else k.get(
                "cfg", reg.LoamRegistrationConfig())
            refits = max(1, min(cfg.corr_refits or cfg.iterations,
                                cfg.iterations))
            self.regs.append(dict(stage=self.stage, steps=cfg.iterations,
                                  fits=refits if cfg.corr_refits else None))
            return register(scan, *a, **k)

        def batch(fn):
            def run(windows, families, losses, options):
                self.batches.append((fn.__name__, windows, families, losses,
                                     options))
                return fn(windows, families, losses, options)
            return run
        gn.lm_loop = lm
        reg.register_loam = registration
        sharded.solve_batched = batch(sharded.solve_batched)
        bsv.solve_batched_shared = batch(bsv.solve_batched_shared)

    def close(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _global_k1(problem, card, label, per_window=False):
    """K1 on a path's own reduced system(s) against its plain version, and
    its times against the library pair (the plain version) and the bound.
    ``problem``: (window, families, losses, options)."""
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    window, fams, losses, opts = problem
    H, g, H_ll, g_l, W, _ = gn.assemble_normal_equations(
        window, fams, losses, per_window=per_window)
    free_d = window.dense_free_mask()
    free = torch.cat([free_d, torch.zeros_like(free_d[..., :1])], dim=-1)
    lm_free = window.landmarks.active & ~window.landmarks.held
    lam = torch.full(H.shape[:-2], opts.initial_lambda, device=H.device)
    Hp, gp, _ = gn._damped_reduced_system(H, g, free, lam, H_ll, g_l, W,
                                          lm_free)
    N = Hp.shape[-1]
    Hp, gp = Hp.reshape(-1, N, N).contiguous(), gp.reshape(-1, N).contiguous()
    x, _ = chol.cholesky_solve_batched(Hp, gp)
    x_ref, _ = chol.cholesky_solve_batched_reference(Hp, gp)
    torch.cuda.synchronize()
    err = float((x - x_ref).abs().max())
    if not err <= X_TOL * float(x_ref.abs().max()):
        raise RuntimeError(f"K1 on the {label} {tuple(Hp.shape)}: err {err}")
    ms, plain_ms = _paired_ms(
        lambda: chol.cholesky_solve_batched(Hp, gp),
        lambda: chol.cholesky_solve_batched_reference(Hp, gp))
    bound = _chol_bound(Hp.shape[0], N)
    print(f"[13] K1 on the {label} {tuple(Hp.shape)}: max|x-x_ref|="
          f"{err:.3e} (bound {X_TOL * float(x_ref.abs().max()):.3e}); kernel "
          f"{ms:.4f} ms, plain = library pair (cholesky_ex + cholesky_solve) "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) (CUDA "
          f"events, {card})", flush=True)
    return dict(shape=tuple(Hp.shape), err=err, ms=ms, plain_ms=plain_ms,
                bound=bound)


def _card_vs_cpu(label, solve, problem, per_window=False):
    """One problem solved on the card and on the CPU plain path under the
    same options: final costs within COST_RTOL, positions within DP_TOL."""
    window, fams, losses, opts = problem
    out, d = solve(window, fams, losses, opts)
    t0 = time.perf_counter()
    out_c, d_c = solve(window.to("cpu"), tuple(f.to("cpu") for f in fams),
                       losses, opts)
    t_cpu = time.perf_counter() - t0
    c1, c1_c = d.final_cost.cpu().double(), d_c.final_cost.double()
    gap = float(((c1 - c1_c).abs() / c1_c.clamp(min=1e-30)).max())
    dp = float((out.imu.p.cpu() - out_c.imu.p).abs().max())
    print(f"[13] {label}, card vs CPU plain path: final cost "
          f"{c1.tolist()} / {c1_c.tolist()} (max rel gap {gap:.2e}, bound "
          f"{COST_RTOL}), max|dp| {dp:.2e} m (bound {DP_TOL}), accepted "
          f"{d.iterations.tolist()} / {d_c.iterations.tolist()}; the CPU "
          f"{t_cpu:.1f} s", flush=True)
    if not (gap <= COST_RTOL and dp <= DP_TOL):
        raise RuntimeError(f"{label}: the card disagrees with the CPU")


def _global_knn_times(match, query, res, card):
    """K2 at the submap-to-submap registration's shapes: the query
    submap's aggregated features placed by the registration's result
    against the match submap's, edges (k=5) and surfaces (k=10)."""
    from beam_slam_tpu_torch.core import lie
    from beam_slam_tpu_torch.device import to_device_many
    me, mev, ms_, msv = match.aggregate_features_submap_frame()
    qe, _, qs, _ = query.aggregate_features_submap_frame()
    dq, dp = to_device_many((res.dq, res.dp), me.device)
    return {label: _knn_times("13", f"the submap registration's {label}",
                              lie.quat_rotate(dq[None], q_pts) + dp[None],
                              r, v, k, card, reps=3)
            for label, q_pts, r, v, k in (("edges", qe, me, mev, 5),
                                          ("surfaces", qs, ms_, msv, 10))}


def run_global(card="", device="cuda", width=WIDTH, online_only=False):
    """Phase 13, global mapping on the card. 13a: the GlobalMapper of
    configs/global_map/global_map.json at its default graph capacities fed
    phase 13's chunks, a loop closure on the last submap and a solve (the
    flush of tests/test_global_mapping.py), then a reloc request for a
    keyframe of the first submap from a pose RELOC_OFF off. 13b: the
    offline refinement of that map (submap refinement, alignment, the
    pose-graph optimization, the batch optimization) and the refinement
    CLI, on the card, on the saved map. Every check raises. Returns the
    launch counts and the kernels' records, and in ``loc`` what phase 14b
    localizes against: the ActiveSubmap of submap 0 as 13a left it, the
    GlobalMapper, the truth and each submap's first chunk.
    ``online_only`` stops after 13a. ``device="cpu"`` (with a smaller
    ``width``) rehearses the phase off the card: no profiler, no kernel
    comparison or times, no CLI."""
    from beam_slam_tpu_torch.core import lie_np
    from beam_slam_tpu_torch.global_mapping import refinement as tref
    from beam_slam_tpu_torch.global_mapping.active_submap import \
        ActiveSubmap
    from beam_slam_tpu_torch.global_mapping.global_map import (
        GlobalMap, global_map_from_config)
    from beam_slam_tpu_torch.global_mapping.submap import Submap
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.models.global_mapper import GlobalMapper
    from beam_slam_tpu_torch.models.lidar_odometry import SlamChunk
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.parallel import sharded
    from beam_slam_tpu_torch.solver import batched as bsv
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.solver.smoother import Transaction

    cuda = device == "cuda"
    dev = None if cuda else device   # entry points: None is the card

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches():
        return (chol.cholesky_solve_batched.launches, knn.knn_topk.launches)

    truth = _loop_truth()
    odom, drift = _drifted(truth)
    gmap = global_map_from_config(GLOBAL_JSON, config_root=str(
        ROOT / "configs"), device=dev)
    gm = GlobalMapper(global_map=gmap)
    cfg = gm.smoother.cfg
    rec = _Recorder()
    try:
        # ---- 13a. the online global mapper
        chol.cholesky_solve_batched.launches = knn.knn_topk.launches = 0
        rec.stage = "online"
        walls, roll_walls, feats = [], [], []
        t_a = time.perf_counter()
        for k, ((q_t, p_t), (q_o, p_o)) in enumerate(zip(truth, odom)):
            fc = feat.extract_features(_hall_grid(q_t, p_t, dev, width,
                                                  seed=k))
            feats.append(fc)
            n_sub = len(gm.map.submaps)
            sync()
            t0 = time.perf_counter()
            gm.process_slam_chunk(SlamChunk(stamp=float(k), q_wb=q_o,
                                            p_wb=p_o, features=fc))
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
            if len(gm.map.submaps) > n_sub > 0:
                roll_walls.append(walls[-1])
        subs = gm.map.submaps
        n_sub = len(subs)
        txn = Transaction(stamp=1e3)
        sync()
        t0 = time.perf_counter()
        found = gm.map.run_loop_closure(n_sub - 1, txn)
        sync()
        loop_wall = 1e3 * (time.perf_counter() - t0)
        if found:
            gm.smoother.send_transaction(txn)
        solve_wall = []

        def flush_solve():   # its own wall, without the profiler's wrap-up
            sync()
            t0 = time.perf_counter()
            gm.optimize()
            sync()
            solve_wall.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        flush = _busy_ms(flush_solve) if cuda else flush_solve()
        prof_s = time.perf_counter() - t0 - solve_wall[0] / 1e3
        flush_wall = loop_wall + solve_wall[0]
        online_l = launches()
        t_online = time.perf_counter() - t_a

        first_k = [int(sm.stamp) for sm in subs]
        sub_err = [round(float(np.linalg.norm(sm.p - truth[k][1])), 4)
                   for sm, k in zip(subs, first_k)]
        last = subs[-1]
        e_last = float(np.linalg.norm(last.p - truth[first_k[-1]][1]))
        d_last = drift[first_k[-1]]
        loops = len(gm.map._loop_closures)
        n_rel = int(gm.smoother.arena_rel.active.sum())
        print(f"[13a] GlobalMapper of {GLOBAL_JSON} (submaps "
              f"{gm.map.params.submap_size_m} m, {type(gm.map.candidate_search).__name__} "
              f"at {getattr(gm.map.candidate_search, 'max_distance_m', '-')} m), graph "
              f"{cfg.max_states} states / {cfg.max_rel_pose_factors} relative "
              f"poses, LM <= {cfg.solver.max_iterations}: {len(truth)} chunks "
              f"around {GLOBAL_RECT[0]} m x {GLOBAL_RECT[1]} m, drift to "
              f"{GLOBAL_DRIFT[0]} m "
              f"/ {GLOBAL_DRIFT[1]} deg; {n_sub} submaps (first chunks "
              f"{first_k}), {gm.n_loop_closures} loop closures at rollovers "
              f"+ {found} at the flush ({[(a, b) for a, b, _ in gm.map._loop_closures]}), "
              f"{n_rel} relative-pose factors in the graph; submaps "
              f"{sub_err} m off the truth (odometry {[round(drift[k], 4) for k in first_k]}); "
              f"last submap {e_last:.4f} m off the truth after the "
              f"flush (odometric drift there {d_last:.4f} m, bound "
              f"{0.5 * d_last:.4f})", flush=True)
        if n_sub < 5 or gm.n_loop_closures + found < 1 or \
                n_rel < n_sub or not e_last <= 0.5 * d_last:
            raise RuntimeError(f"13a: {n_sub} submaps, {loops} loops, "
                               f"{n_rel} relative poses, last submap "
                               f"{e_last} m off (drift {d_last})")

        # the reloc request: a keyframe of the first submap, its features
        # seen from the truth, asked from a pose RELOC_OFF off. The third
        # keyframe: the search ranks submaps by the distance of their
        # origins, and the first submap's (held by the graph's prior) is
        # then the nearest
        k_r = first_k[0] + min(2, len(subs[0].lidar_keyframes) - 1)
        rng = np.random.default_rng(GLOBAL_SEED + 1)
        th = rng.uniform(0, 2 * np.pi)
        q_t, p_t = truth[k_r]
        q_est = lie_np.quat_mul(q_t, lie_np.so3_exp_quat(np.array(
            [0, 0, np.deg2rad(RELOC_OFF[1])], np.float32))).astype(np.float32)
        p_est = p_t + (RELOC_OFF[0] * np.array([np.cos(th), np.sin(th), 0])
                       ).astype(np.float32)
        rec.stage = "reloc"
        n_reg = len(rec.regs)
        probe = Submap(2e3, q_est, p_est, device=dev)
        cands = gm.map.candidate_search.find(
            subs + [probe], n_sub, gm.map.params.max_candidates)
        t0 = time.perf_counter()
        ans = gm.process_reloc_request(2e3, feats[k_r], q_est, p_est)
        reloc_wall = 1e3 * (time.perf_counter() - t0)
        if ans is None:
            raise RuntimeError("13a: the reloc request found no match")
        e_p = float(np.linalg.norm(ans[1] - p_t))
        e_r = _so3_err(ans[0], q_t)
        print(f"[13a] reloc request for chunk {k_r} from {RELOC_OFF[0]} m / "
              f"{RELOC_OFF[1]} deg off (candidate submaps {cands}): "
              f"{e_p:.4f} m / {e_r:.4f} rad off the "
              f"truth (bounds {RELOC_TOL}), {len(rec.regs) - n_reg} "
              f"registrations, {reloc_wall:.1f} ms", flush=True)
        if not (e_p <= RELOC_TOL[0] and e_r <= RELOC_TOL[1]):
            raise RuntimeError("13a: the reloc request missed the truth")
        print(f"[13a] process_slam_chunk wall ({card}): median "
              f"{statistics.median(walls):.1f} ms, max {max(walls):.1f} ms "
              f"over {len(walls)} chunks; on a rollover (a solve) max "
              f"{max(roll_walls or [0.0]):.1f} ms over {len(roll_walls)}; the "
              f"flush {flush_wall:.1f} ms (its loop closure {loop_wall:.1f} "
              f"ms, its solve {solve_wall[0]:.1f} ms under the profiler); 13a "
              f"{t_online:.1f} s; K1 {online_l[0]}, K2 {online_l[1]} "
              f"launches", flush=True)
        if flush:
            print(f"[13a] the flush's solve under the profiler: {flush[1]} "
                  f"device ops, device time {flush[0]:.2f} ms of "
                  f"{solve_wall[0]:.1f} ms wall, so the card is idle "
                  f"{100 * (1 - flush[0] / solve_wall[0]):.1f}% ({card}); "
                  f"the profiler's wrap-up {prof_s:.1f} s", flush=True)
        elif cuda:
            print("[13a] the flush's solve under the profiler: the profiler "
                  "lost its events; device time not measured", flush=True)
        active = ActiveSubmap(device=dev)
        active.update_from_submap(subs[0])
        loc = dict(gm=gm, truth=truth, first_k=first_k, active=active)
        if online_only:
            return dict(launches=dict(k1=online_l[0], k2=online_l[1]),
                        loc=loc)

        # ---- 13b. the offline refinement: run_full_refinement's four
        # stages in its order, each timed and counted
        kf_pos = lambda: {(si, ki): kf.p.copy()  # noqa: E731
                          for si, sm in enumerate(subs)
                          for ki, kf in enumerate(sm.lidar_keyframes)}
        kf_before = kf_pos()
        stage_l, stage_s, stats = {}, {}, {}
        for name in ("run_submap_refinement", "run_submap_alignment",
                     "run_pose_graph_optimization",
                     "run_batch_optimization"):
            rec.stage = name
            l0 = launches()
            sync()
            t0 = time.perf_counter()
            stats[name] = getattr(tref, name)(gm.map)
            sync()
            stage_s[name] = time.perf_counter() - t0
            stage_l[name] = tuple(b - a for a, b in zip(l0, launches()))
            if name == "run_submap_refinement":
                kf_refined = kf_pos()
    finally:
        rec.close()
    total_l = launches()
    print(f"[13b] run_full_refinement's stages ({card}): " + "; ".join(
        f"{n} {stage_s[n]:.1f} s, K1 {stage_l[n][0]} / K2 {stage_l[n][1]} "
        f"launches, returns {stats[n]}" for n in stage_s), flush=True)

    # submap refinement lowers the demeaned per-keyframe error. A submap's
    # keyframes are stored in its frame, the odometry's pose of its first
    # chunk; under a drift that is locally rigid that frame holds the true
    # geometry relative to the first chunk's true pose, the truth here
    def kf_err(pos):
        out = []
        for si, sm in enumerate(subs):
            q_f, p_f = truth[int(sm.stamp)]
            d = np.stack([pos[(si, ki)] - lie_np.quat_rotate(
                lie_np.quat_conj(q_f), truth[int(kf.stamp)][1] - p_f)
                for ki, kf in enumerate(sm.lidar_keyframes)])
            out.extend(np.linalg.norm(d - d.mean(0), axis=1))
        return float(np.mean(out))
    e0, e1 = kf_err(kf_before), kf_err(kf_refined)
    batch = stats["run_batch_optimization"]
    bad = [r for r in rec.solves if not (
        all(np.isfinite(r["c1"])) and all(
            c1 <= c0 for c0, c1 in zip(r["c0"], r["c1"])))]
    steps = sum(r["n_iter"] for r in rec.solves)
    reg_steps = sum(r["steps"] for r in rec.regs)
    print(f"[13b] demeaned keyframe error {e0:.4f} m before submap "
          f"refinement, {e1:.4f} m after; the batch optimization kept "
          f"{batch['loops_kept']} of {batch['loops_found']} loops over "
          f"{batch['keyframes']} keyframes; {len(rec.solves)} solves "
          f"({sum(r['B'] for r in rec.solves)} systems), {steps} LM steps, "
          f"K1 {total_l[0]} launches; {len(rec.regs)} registrations, "
          f"{reg_steps} GN steps, K2 {total_l[1]} launches", flush=True)
    for r in rec.solves:
        print(f"[13] solve ({r['stage']}): B={r['B']}, {r['N']} dense dof, "
              f"{r['steps']} LM steps run, accepted {r['accepted']}, cost "
              f"{r['c0']} -> {r['c1']}", flush=True)
    if not (e1 < e0 and batch["loops_kept"] >= 1 and not bad):
        raise RuntimeError(f"13b: keyframe error {e0} -> {e1}, batch "
                           f"{batch}, bad solves {bad}")
    if cuda and not (total_l[0] >= steps and total_l[1] >= 2 * reg_steps):
        raise RuntimeError(f"13: K1 {total_l[0]} launches for {steps} LM "
                           f"steps, K2 {total_l[1]} for {reg_steps} "
                           f"registration steps")
    out = dict(launches=dict(k1=total_l[0], k2=total_l[1]), loc=loc)
    if not cuda:
        return out

    # K1 on the global graph's own system (1, 2048) and on a submap
    # refinement batch's (B, 256); each problem card vs CPU
    g_prob = gm.smoother._build_device_problem() + (cfg.solver,)
    out["k1_global"] = _global_k1(g_prob, card, "global graph's system")
    _card_vs_cpu("the global graph's last problem", gn.solve, g_prob)
    name, *b_prob = rec.batches[0]
    per_window = name == "solve_batched"
    out["k1_batch"] = _global_k1(b_prob, card, "submap refinement batch",
                                 per_window=per_window)
    _card_vs_cpu(f"a submap refinement batch ({name})",
                 sharded.solve_batched if per_window
                 else bsv.solve_batched_shared, b_prob)
    if out["k1_global"]["shape"][1:] != (2048, 2048) or \
            out["k1_batch"]["shape"][1:] != (256, 256):
        raise RuntimeError(f"13: K1 shapes {out['k1_global']['shape']}, "
                           f"{out['k1_batch']['shape']}")

    # the refinement CLI, on the card, on the map saved to a directory: in
    # its own process, while this one holds a registration on the CPU. It
    # runs one stage, the alignment: run_full_refinement has just run them
    # all, and the CLI's submap refinement took 52–63 s of the script's
    # 1200 s limit for nothing its in-process run did not show
    tmp = tempfile.TemporaryDirectory()
    gm.save(tmp.name + "/map")
    t0 = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m",
         "beam_slam_tpu_torch.tools.global_map_refinement_main",
         "--globalmap_dir", tmp.name + "/map", "--output_path",
         tmp.name + "/out", "--run_submap_alignment"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # one submap-to-submap registration, card vs CPU: the reloc query
        # (one keyframe) against the first submap
        query = Submap(2e3, q_est, p_est, device=dev)
        query.add_lidar_keyframe(2e3, q_est, p_est, feats[k_r])
        ref = gm.map.refinement
        r_card = ref.refine(subs[0], query)
        t1 = time.perf_counter()
        r_cpu = ref.refine(_submap_on(subs[0], "cpu"),
                           _submap_on(query, "cpu"))
        t_cpu = time.perf_counter() - t1
        e_p = float(np.linalg.norm(r_card.dp - r_cpu.dp))
        e_r = _so3_err(r_card.dq, r_cpu.dq)
        print(f"[13] one submap-to-submap registration (the reloc query "
              f"against submap 0), card vs CPU plain path: {e_p:.2e} m / "
              f"{e_r:.2e} rad (bounds {CARD_CPU_DP} / {CARD_CPU_ROT}), "
              f"successful {r_card.successful} / {r_cpu.successful}; the "
              f"CPU {t_cpu:.1f} s", flush=True)
        if not (e_p <= CARD_CPU_DP and e_r <= CARD_CPU_ROT
                and r_card.successful == r_cpu.successful):
            raise RuntimeError("13: the submap registration on the card "
                               "disagrees with the CPU")
        _, err = cli.communicate(timeout=900)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise RuntimeError(f"13: the refinement CLI failed: "
                               f"{err[-3000:]}")
        with open(tmp.name + "/out/refinement_stats.json") as f:
            cli_stats = json.load(f)
        back = GlobalMap.load(tmp.name + "/out")
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        tmp.cleanup()
    moved = max(float(np.abs(a.p - b.p).max())
                for s2, s1 in zip(back.submaps, subs)
                for a, b in zip(s2.lidar_keyframes, s1.lidar_keyframes))
    if len(back.submaps) != n_sub or not np.isfinite(moved) or \
            not 0 <= cli_stats["submaps_aligned"] < n_sub:
        raise RuntimeError(f"13: the CLI's map: {len(back.submaps)} "
                           f"submaps, moved {moved}, {cli_stats}")
    print(f"[13b] the refinement CLI (python -m beam_slam_tpu_torch.tools."
          f"global_map_refinement_main --run_submap_alignment, on the card) "
          f"on the saved map: {cli_s:.1f} s of wall with its start-up, beside "
          f"the registration on the CPU; stats {cli_stats}; its map loads "
          f"back, keyframes moved up to {moved:.4f} m ({card})", flush=True)

    # K2 at the loop closure's shapes (the last submap against its match)
    ci, qi, res = gm.map._loop_closures[-1]
    out["k2"] = _global_knn_times(subs[ci], subs[qi], res, card)
    return out


def _multiscan_poses(n):
    """Phase 14a's true poses in the HALL: along the loop's first side,
    ~0.3 m and ~0.6° of yaw apart, with some sway."""
    from beam_slam_tpu_torch.core import lie_np
    x0, y0 = GLOBAL_ORIGIN
    return [(lie_np.so3_exp_quat(np.array(
        [0.004 * np.sin(i), 0.003 * (np.cos(i) - 1.0), 0.01 * i],
        np.float32)),
        np.array([x0 + 4.0 + 0.3 * i, y0 + 0.05 * np.sin(0.7 * i),
                  0.005 * i], np.float32)) for i in range(n)]


def _on(x, device):
    """A FeatureCloud, or a tuple of tensors, on ``device``."""
    return x.to(device) if hasattr(x, "to") else tuple(t.to(device)
                                                       for t in x)


def _knn_times(tag, label, q, r, v, k, card, reps=20):
    """K2 at a path's shape against its plain version (phase 7's checks),
    timed against the plain version, ``cdist`` + ``topk`` and its bound.
    The library yardstick runs in blocks of KNN_LIB_BLOCK queries: one
    call at a submap's shape would need a Q × R distance matrix of
    ~40 GB."""
    from beam_slam_tpu_torch.ops import knn
    q, r, v = q.contiguous(), r.contiguous(), v.contiguous()
    err = _knn_check(knn, q, r, v, k, label)
    Q, R, n_valid = q.shape[0], r.shape[0], int(v.sum())
    k_ms, plain_ms = _paired_ms(lambda: knn.knn_topk(q, r, v, k),
                                lambda: knn.knn_topk_reference(q, r, v, k),
                                reps=reps)
    lib_ms = _event_ms(lambda: [torch.topk(torch.cdist(
        qc, r).masked_fill_(~v, float("inf")), k, largest=False)
        for qc in torch.split(q, KNN_LIB_BLOCK)], reps)
    try:
        dev_ms, how = _device_ms(lambda: knn.knn_topk(q, r, v, k),
                                 "knn_topk_kernel", reps=reps), "profiler"
    except RuntimeError:   # it lost the events: a call's CUDA events,
        dev_ms, how = k_ms, "CUDA events"   # at ms scale the same
    bound = _knn_bound(Q, R, n_valid, k)
    print(f"[{tag}] K2 at {label} ({Q}, {R}, k={k}), {n_valid} valid refs: "
          f"kernel {dev_ms:.4f} ms on the device ({how}), {k_ms:.4f} ms a "
          f"call (CUDA events); plain {plain_ms:.3f} ms, cdist+topk (in "
          f"blocks of {KNN_LIB_BLOCK} queries) {lib_ms:.3f} ms (CUDA "
          f"events); bound {bound[0]:.4f} ms ({bound[1]}) ({card})",
          flush=True)
    return dict(ms=dev_ms, call_ms=k_ms, plain=plain_ms, lib=lib_ms,
                bound=bound, err=err, shape=(Q, R, k))


def run_multiscan(card="", device="cuda"):
    """Phase 14a: MultiScan registration from configs/ with each matcher
    of MULTISCAN_MATCHERS on MULTISCAN_SCANS hall scans at 16 × 1800 (K2 in
    LOAM, ICP and GICP; NDT's grid needs no search). Every factor within
    its matcher's bounds of the truth; one registration per matcher card
    vs the CPU plain path; K2 at ICP's and GICP's shapes against its plain
    version. Returns the K2 launches and records. ``device="cpu"``
    rehearses the phase off the card: no profiler, no comparison."""
    from beam_slam_tpu_torch.core import lie
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.solver.smoother import Transaction

    cuda = device == "cuda"
    dev = None if cuda else device   # entry points: None is the card

    def sync():
        if cuda:
            torch.cuda.synchronize()

    poses = _multiscan_poses(MULTISCAN_SCANS)
    rng = np.random.default_rng(MULTISCAN_SEED)
    seeds = [poses[0]] + [_perturbed(q, p, rng) for q, p in poses[1:]]
    stamps = [0.1 * i for i in range(MULTISCAN_SCANS)]
    grids = [_hall_grid(q, p, dev, WIDTH, seed=100 + i)
             for i, (q, p) in enumerate(poses)]
    out = dict(launches=0, k2={})
    for name, bounds in MULTISCAN_MATCHERS.items():
        strat, feat_cfg = tsr.create_scan_registration(
            MULTISCAN_JSON, f"matchers/{name}.json",
            config_root=str(ROOT / "configs"), device=dev)
        fcs = [feat.extract_features(g, feat_cfg) if feat_cfg else None
               for g in grids]
        sync()
        knn.knn_topk.launches = 0
        rels, ms, n_reg = [], [], 0
        for i in range(MULTISCAN_SCANS):
            txn = Transaction(stamp=stamps[i])
            sync()
            t0 = time.perf_counter()
            ok = strat.register_new_scan(stamps[i], fcs[i], *seeds[i], txn,
                                         grid=grids[i])
            sync()
            if i > 0:
                ms.append(1e3 * (time.perf_counter() - t0))
            if not ok:
                raise RuntimeError(f"14a {name}: scan {i} was not accepted")
            n_reg += min(i, strat.num_neighbors)
            rels += txn.rel_poses
        launches = knn.knn_topk.launches
        out["launches"] += launches
        if len(rels) != n_reg:
            raise RuntimeError(f"14a {name}: {len(rels)} factors for "
                               f"{n_reg} registrations")
        held = json.loads(MULTISCAN_JAX.read_text()).get(name)
        if held is None:
            worst = _check_factors(rels, poses, stamps, f"14a {name}",
                                   bounds)
            verdict = (f"worst {worst[0]:.4f} m / {worst[1]:.4f} rad off "
                       f"the truth (bounds {bounds[0]} / {bounds[1]})")
        else:
            worst = _check_factors(rels, poses, stamps, f"14a {name}",
                                   (np.inf, np.inf))
            gaps = [(float(np.linalg.norm(f.dp - np.asarray(h[3]))),
                     _so3_err(f.dq, np.asarray(h[2], np.float32)))
                    for f, h in zip(rels, held)]
            if [(stamps.index(f.stamp_i), stamps.index(f.stamp_j))
                    for f in rels] != [tuple(h[:2]) for h in held] or not (
                    max(g[0] for g in gaps) <= CARD_CPU_DP
                    and max(g[1] for g in gaps) <= CARD_CPU_ROT):
                raise RuntimeError(f"14a {name}: the factors differ from "
                                   f"the JAX package's by {gaps}")
            verdict = (f"within {max(g[0] for g in gaps):.2e} m / "
                       f"{max(g[1] for g in gaps):.2e} rad of the JAX "
                       f"package's CPU factors (bounds {CARD_CPU_DP} / "
                       f"{CARD_CPU_ROT}); worst {worst[0]:.4f} m / "
                       f"{worst[1]:.4f} rad off the truth, as the JAX "
                       f"package's (its bounds {bounds[0]} / {bounds[1]} "
                       f"are missed by both)")
        print(f"[14a] MultiScan + {name} ({type(strat).__name__}, "
              f"{strat.num_neighbors} neighbours) at {N_RINGS}x{WIDTH}: "
              f"{MULTISCAN_SCANS} scans accepted, {len(rels)} factors, "
              f"{verdict}; register_new_scan median "
              f"{statistics.median(ms):.2f} ms over {len(ms)} (host clock, "
              f"synchronised; {card}); K2 launches {launches}, "
              f"{launches / n_reg:.1f} a registration", flush=True)
        if not cuda:
            continue

        # the last scan against its newest neighbour, card vs CPU
        _, r_q, r_p, r_cloud = strat.refs[-2]
        cloud = strat.refs[-1][3]
        q_s, p_s = strat._lidar_from_baselink(*seeds[-1])

        def match(d):
            return strat._match(_on(cloud, d), _on(r_cloud, d),
                                *tsr._pose_to_device(r_q, r_p, d),
                                *tsr._pose_to_device(q_s, p_s, d))
        wall = []

        def timed():
            t0 = time.perf_counter()
            match(strat.device)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        busy = _busy_ms(timed, marker="")
        res, res_cpu = match(strat.device), match("cpu")
        dp = float(torch.linalg.vector_norm(res.p.cpu() - res_cpu.p))
        dr = _so3_err(res.q.cpu().numpy(), res_cpu.q.numpy())
        same = bool(res.converged) == bool(res_cpu.converged)
        idle = ("device time not measured (the profiler lost its events)"
                if busy is None else
                f"device time {busy[0]:.2f} ms of {wall[0]:.1f} ms wall "
                f"under the profiler ({busy[1]} device ops), idle "
                f"{100 * (1 - busy[0] / wall[0]):.1f}%")
        print(f"[14a] {name}: one registration, card vs CPU plain path: "
              f"|dp|={dp:.2e} m, rotation {dr:.2e} rad (bounds "
              f"{CARD_CPU_DP} / {CARD_CPU_ROT}), converged "
              f"{bool(res.converged)} / {bool(res_cpu.converged)}; {idle} "
              f"({card})", flush=True)
        if not (dp <= CARD_CPU_DP and dr <= CARD_CPU_ROT and same):
            raise RuntimeError(f"14a {name}: the registration on the card "
                               f"disagrees with the CPU plain path")
        if name in ("icp", "gicp"):
            pts, valid = cloud
            r_pts, r_valid = r_cloud
            q_r, p_r = tsr._pose_to_device(r_q, r_p, strat.device)
            query = lie.quat_rotate(res.q[None], pts) + res.p[None]
            ref = lie.quat_rotate(q_r[None], r_pts) + p_r[None]
            k = 1 if name == "icp" else strat.matcher_cfg.k_normal
            out["k2"][name] = _knn_times("14a", f"{name}'s correspondences",
                                         query, ref, r_valid, k, card)
    return out


def run_localize(loc, card="", device="cuda"):
    """Phase 14b: a LidarTracker localizing on 13a's map. Its active submap
    is submap 0 as 13a left it (``loc``), its smoother lio.yaml's (the sync
    tick; K1 at (1, 1024) every LM step), its local strategy the configs/
    scan-to-map one, its reloc requests answered by the GlobalMapper. It is
    fed LOCALIZE_SCANS hall scans 0.5 m apart in submap 0's first half,
    0.2 m to the side of its keyframes, seeds perturbed as phase 6's; each scan also goes through the
    LidarFeatureExtractor, the LidarScanDeskewer and LidarAggregation
    (a moving frame initializer), each card vs CPU. Returns the launches
    and K2's records at the tracker's scan-to-submap shapes."""
    from beam_slam_tpu_torch.core import lie, lie_np
    from beam_slam_tpu_torch.lidar import features as feat
    from beam_slam_tpu_torch.lidar import registration as treg
    from beam_slam_tpu_torch.lidar import scan_registration as tsr
    from beam_slam_tpu_torch.models.lidar_aggregation import \
        LidarAggregation
    from beam_slam_tpu_torch.models.lidar_feature_extractor import \
        LidarFeatureExtractor
    from beam_slam_tpu_torch.models.lidar_scan_deskewer import \
        LidarScanDeskewer
    from beam_slam_tpu_torch.models.lidar_tracker import LidarTracker
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.solver.smoother import FixedLagSmoother

    cuda = device == "cuda"
    dev = None if cuda else device   # entry points: None is the card

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gm, truth, first_k, active = (loc[k] for k in ("gm", "truth", "first_k",
                                                    "active"))
    # 0.5 m apart from half a metre past submap 0's origin, 0.2 m to the
    # side of its keyframes: the nearest submap origin stays submap 0's, so
    # the reloc search ranks it first and answers in its frame (the graph
    # holds it at the truth; a later submap's frame carries the graph's
    # error: 0.169 m in the CPU rehearsal at 16 × 450)
    q0, p0 = truth[first_k[0]]
    poses = []
    for i in range(LOCALIZE_SCANS):
        dq = lie_np.so3_exp_quat(np.array([0, 0, 0.02 * np.sin(i)],
                                          np.float32))
        poses.append((lie_np.quat_mul(q0, dq).astype(np.float32),
                      (p0 + lie_np.quat_rotate(q0, np.array(
                          [0.5 + 0.5 * i, 0.2, 0.0], np.float32))).astype(
                          np.float32)))
    rng = np.random.default_rng(LOCALIZE_SEED)
    seeds = [poses[0]] + [_perturbed(q, p, rng) for q, p in poses[1:]]
    stamps = [5e3 + LOCALIZE_DT * i for i in range(LOCALIZE_SCANS)]

    sm = FixedLagSmoother(lio_smoother_config(), device=dev)
    sm.register_extrinsic(tsr.LIDAR_SENSOR, np.array([1, 0, 0, 0],
                                                     np.float32),
                          np.zeros(3, np.float32))
    strat, feat_cfg = tsr.create_scan_registration(
        *LIO_JSON, config_root=str(ROOT / "configs"), device=dev)
    answers = []

    def reloc(stamp, features, q, p):
        t0 = time.perf_counter()
        ans = gm.process_reloc_request(stamp, features, q, p)
        answers.append((stamp, ans, 1e3 * (time.perf_counter() - t0)))
    tracker = LidarTracker(sm, strat, active_submap=active,
                           loam_cfg=feat_cfg, reloc_request_cb=reloc,
                           device=dev)
    tracker.initialize(stamps[0] - 1.0)
    extractor = LidarFeatureExtractor(loam_cfg=feat_cfg, device=dev)

    def moving(t):   # 1 m/s along x, 0.2 rad/s of yaw
        dt = t - stamps[0]
        return (lie_np.so3_exp_quat(np.array([0, 0, 0.2 * dt], np.float32)),
                np.array([dt, 0.1 * dt, 0.0], np.float32))
    deskew, deskew_cpu = LidarScanDeskewer(moving), LidarScanDeskewer(moving)
    agg, agg_cpu = LidarAggregation(moving), LidarAggregation(moving)

    chol.cholesky_solve_batched.launches = knn.knn_topk.launches = 0
    ms, counts, d_err, last = [], None, 0.0, None
    for i, (q, p) in enumerate(poses):
        grid = _hall_grid(q, p, dev, WIDTH, seed=200 + i)
        tracker.frame_initializer = lambda t, s=seeds[i]: s
        sync()
        t0 = time.perf_counter()
        ok = tracker.process_scan(stamps[i], grid)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        if not ok:
            raise RuntimeError(f"14b: scan {i} was not accepted")
        meas = extractor.process_pointcloud(stamps[i], grid)
        fc = feat.extract_features(grid, feat_cfg)
        counts = meas.counts()
        if counts != {k: int(getattr(fc, k + "_valid").sum())
                      for k in counts}:
            raise RuntimeError(f"14b: feature extractor counts {counts}")
        g_card = deskew.process_scan(stamps[i], grid)
        g_cpu = deskew_cpu.process_scan(stamps[i], grid.to("cpu"))
        d_err = max(d_err, float((g_card.xyz.cpu() - g_cpu.xyz).abs().max()))
        agg.add_scan(stamps[i], grid)
        agg_cpu.add_scan(stamps[i], grid.to("cpu"))
        last = (fc, seeds[i])
    k2_scans = knn.knn_topk.launches
    (pts, valid), (pts_c, valid_c) = (agg.aggregate(stamps[-1]),
                                      agg_cpu.aggregate(stamps[-1]))
    a_err = float(np.abs(pts - pts_c).max())
    if not (np.array_equal(valid, valid_c) and a_err <= LOCAL_CPU_TOL
            and d_err <= LOCAL_CPU_TOL and deskew.published == len(poses)):
        raise RuntimeError(f"14b: deskewer {d_err} / aggregation {a_err} m "
                           f"card vs CPU")
    sync()
    t0 = time.perf_counter()
    diag = sm.run_once()
    sync()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    k1 = chol.cholesky_solve_batched.launches

    # checks against the truth
    e_odom = [(float(np.linalg.norm(p - poses[i][1])),
               _so3_err(q, poses[i][0]))
              for i, (_, q, p) in enumerate(tracker.odom_global)]
    e_win = [float(np.linalg.norm(sm.get_state(t)["p"]
                                  - poses[stamps.index(t)][1]))
             for t in sm.current_stamps()]
    e_reloc = [(float(np.linalg.norm(a[1] - poses[stamps.index(t)][1])),
                _so3_err(a[0], poses[stamps.index(t)][0]))
               for t, a, _ in answers if a is not None]
    worst = lambda es, j: max(e[j] for e in es)  # noqa: E731
    print(f"[14b] LidarTracker on submap 0 of 13a's map (ActiveSubmap "
          f"{int(active.get_loam_map()[1].sum())} edges + "
          f"{int(active.get_loam_map()[3].sum())} surfaces valid), "
          f"configs/{LIO_YAML}'s smoother, {LIO_JSON[0]}: {len(poses)} "
          f"scans, {tracker.global_anchor_count} anchored; odom_global "
          f"worst {worst(e_odom, 0):.4f} m / {worst(e_odom, 1):.4f} rad off "
          f"the truth (bounds {GT_TRANS} / {GT_ROT}); {len(answers)} reloc "
          f"requests, {len(e_reloc)} answered, off the truth by "
          f"{[(round(a, 4), round(b, 4)) for a, b in e_reloc]} (m, rad; "
          f"bounds {RELOC_TOL}), "
          f"{statistics.median([a[2] for a in answers]):.1f} ms each; "
          f"run_once: cost {float(diag.initial_cost):.6g} -> "
          f"{float(diag.final_cost):.6g}, {int(diag.iterations)} accepted, "
          f"{k1} K1 launches, {solve_ms:.1f} ms; window of "
          f"{len(e_win)} states worst {max(e_win):.4f} m off (bound "
          f"{GT_TRANS}); process_scan median {statistics.median(ms):.1f} ms "
          f"(min {min(ms):.1f}, max {max(ms):.1f}; {card}); K2 "
          f"{k2_scans} launches; feature counts {counts} equal "
          f"extract_features'; card vs CPU: deskewed points {d_err:.2e} m, "
          f"aggregated {a_err:.2e} m over {len(pts)} points (bound "
          f"{LOCAL_CPU_TOL})", flush=True)
    if not (tracker.global_anchor_count >= len(poses) - 1
            and worst(e_odom, 0) < GT_TRANS and worst(e_odom, 1) < GT_ROT
            and e_reloc and worst(e_reloc, 0) <= RELOC_TOL[0]
            and worst(e_reloc, 1) <= RELOC_TOL[1]
            and max(e_win) < GT_TRANS
            and np.isfinite(float(diag.final_cost))):
        raise RuntimeError("14b: the tracker missed the truth")
    out = dict(launches=dict(k1=k1, k2=k2_scans), k2={})
    if not cuda:
        return out
    if k1 < 1 or k2_scans < 2 * len(poses):
        raise RuntimeError(f"14b: K1 {k1}, K2 {k2_scans} launches")

    # one global registration, card vs CPU, and K2 at its shapes
    fc, (q_s, p_s) = last
    cfg = tracker.global_reg_cfg
    world = active.get_loam_map()
    res = treg.register_loam(fc, *world, *tsr._pose_to_device(
        q_s, p_s, "cuda"), cfg)
    res_cpu = treg.register_loam(fc.to("cpu"), *(w.cpu() for w in world),
                                 *tsr._pose_to_device(q_s, p_s, "cpu"), cfg)
    dp = float(torch.linalg.vector_norm(res.p.cpu() - res_cpu.p))
    dr = _so3_err(res.q.cpu().numpy(), res_cpu.q.numpy())
    print(f"[14b] one scan-to-submap registration, card vs CPU plain path: "
          f"|dp|={dp:.2e} m, rotation {dr:.2e} rad (bounds {CARD_CPU_DP} / "
          f"{CARD_CPU_ROT}), converged {bool(res.converged)} / "
          f"{bool(res_cpu.converged)}", flush=True)
    if not (dp <= CARD_CPU_DP and dr <= CARD_CPU_ROT
            and bool(res.converged) == bool(res_cpu.converged)):
        raise RuntimeError("14b: the global registration on the card "
                           "disagrees with the CPU plain path")
    me, mev, ms_, msv = world
    for label, a, b, r, v, k in (
            ("edges", fc.edge_strong, fc.edge_weak, me, mev, cfg.k_edge),
            ("surfaces", fc.surf_strong, fc.surf_weak, ms_, msv,
             cfg.k_surf)):
        q_pts = lie.quat_rotate(res.q[None], torch.cat([a, b])) + res.p[None]
        out["k2"][label] = _knn_times("14b", f"the scan-to-submap {label}",
                                      q_pts, r, v, k, card)
    return out


def run_localization(loc, card="", device="cuda"):
    """Phase 14: 14a MultiScan, 14b the tracker on 13a's map. Returns the
    launch counts and K2's records."""
    t0 = time.perf_counter()
    ms = run_multiscan(card, device)
    lz = run_localize(loc, card, device)
    print(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=dict(k1=lz["launches"]["k1"],
                              k2=ms["launches"] + lz["launches"]["k2"]),
                k2=dict(ms["k2"], **{"submap " + k: v
                                     for k, v in lz["k2"].items()}))


# ---------------------------------------------------------------------------
# Phase 15: the last modules of the port (coupled PGO and BA over factor
# shards, the sharded refinement step, the threaded mapper, descriptors and
# the image database, the calibration viewer, the unary IDP factor)
# ---------------------------------------------------------------------------


# 15a: the coupled whole-trajectory pose graph at 1000 keyframes — the ring
# of tests/test_distributed_pgo.py:20 at N = 1000 (D = 6000): 999 odometry
# factors, 40 loop closures half a ring apart, a prior on pose 0, the
# test's information weights; a per-step drift of 0.0126 m, so the walk
# ends as far off as the test's 64-pose ring at 0.05 m (0.05·√(64/1000)).
PGO_N, PGO_LOOPS, PGO_DRIFT, PGO_SEED, PGO_ITERS = 1000, 40, 0.0126, 23, 20
PGO_SHARDS, PGO_HOSTS = 8, (2, 4)
PGO_POS_TOL, PGO_GT_TOL, PGO_COST_RATIO = 1e-4, 1e-3, 1e-6
# tests/test_distributed_ba.py:44-54; tests/test_idp.py:233-235
BA_COST_RTOL, BA_IMU_TOL, BA_LM_TOL = 1e-3, 2e-3, 5e-3
IDP_COST, IDP_RHO, IDP_CARD_CPU = 1e-6, 1e-3, 1e-4
REFINE_SHARDS, REFINE_POS = 8, 5e-4

MAPPER_LOCKSTEP_TOL = 1e-5        # 15d: lockstep window vs the sync mapper
# 15d's lockstep ignites after 0.5 m of path, not lio.yaml's 2.0 m: at 2.0
# m the ignition waits for frame 40, and the two replays of 43 frames took
# 64 s of the script's time limit; at 0.5 m it comes at frame 7
LOCKSTEP_INIT_M = 0.5
# 15e: 20 views of 12b's texture, each shifted by up to ±6 px and with
# Gaussian noise of 2 grey levels (numpy seed 29); descriptor bits may
# differ card vs CPU only where a sample rounds differently
DESC_SEED, DESC_VIEWS, DESC_BITS, DESC_WORDS = 29, 20, 5e-3, 64
VIEWER_PX = 1e-3                  # 15f: projection card vs CPU, pixels


def pgo_ring(device, N=PGO_N, n_loops=PGO_LOOPS, drift=PGO_DRIFT,
             seed=PGO_SEED):
    """tests/test_distributed_pgo.py::ring_problem in numpy, on ``device``:
    (PGOState, PGOFactors, PGOPriors, p_gt [N, 3])."""
    from beam_slam_tpu_torch.core import lie_np
    from beam_slam_tpu_torch.device import to_device_many
    from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    p_gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang),
                     0.2 * np.sin(3 * ang)], 1).astype(np.float32)
    q_gt = np.stack([lie_np.so3_exp_quat(np.asarray([0, 0, a], np.float32))
                     for a in ang]).astype(np.float32)
    d = np.cumsum(rng.standard_normal((N, 3)) * drift, axis=0)
    p0 = p_gt + d.astype(np.float32)
    q0 = np.stack([lie_np.quat_mul(q_gt[i], lie_np.so3_exp_quat(
        rng.standard_normal(3).astype(np.float32) * 0.02))
        for i in range(N)]).astype(np.float32)
    p0[0], q0[0] = p_gt[0], q_gt[0]
    free = np.ones(N, bool)
    free[0] = False
    ii = list(range(N - 1))
    jj = [i + 1 for i in ii]
    for k in range(n_loops):
        i = (k * 7) % (N // 2)
        ii.append(i)
        jj.append(i + N // 2)
    ii, jj = np.asarray(ii), np.asarray(jj)
    q_inv = lie_np.quat_conj(q_gt[ii])
    dq = lie_np.quat_mul(q_inv, q_gt[jj]).astype(np.float32)
    dp = lie_np.quat_rotate(q_inv, p_gt[jj] - p_gt[ii]).astype(np.float32)
    F = len(ii)
    state = dpgo.PGOState(*to_device_many((q0, p0, free), device))
    fac = dpgo.PGOFactors(*to_device_many((
        ii.astype(np.int64), jj.astype(np.int64), dq, dp,
        np.tile(1e2 * np.eye(6, dtype=np.float32), (F, 1, 1)),
        np.ones(F, bool)), device))
    pri = dpgo.PGOPriors(*to_device_many((
        np.zeros(1, np.int64), q_gt[:1], p_gt[:1],
        1e3 * np.eye(6, dtype=np.float32)[None], np.ones(1, bool)), device))
    return state, fac, pri, p_gt


def unary_idp_problem(device):
    """The unary inverse-depth problem of tests/test_idp.py:185-235 on
    ``device``: an anchor camera at the origin, a landmark at bearing
    (0.1, -0.05) and ρ = 0.2, seen from a measurement pose whose seed is
    off by (0.01, -0.01, 0.02) rad and (0.05, -0.04, 0.03) m, ρ seeded
    30% high, the extrinsic held, a 1e3 pose prior at the true measurement
    pose. Returns (window, families, losses, rho_gt)."""
    from beam_slam_tpu_torch.core import factors as fc
    from beam_slam_tpu_torch.core import lie as tlie
    from beam_slam_tpu_torch.core.window import WindowState
    f32 = dict(dtype=torch.float32, device=device)
    bearing = torch.tensor([0.1, -0.05], **f32)
    rho_gt = 0.2
    X_w = torch.cat([bearing, torch.ones(1, **f32)]) / rho_gt
    q_m = tlie.so3_exp_quat(torch.tensor([0.0, 0.02, 0.0], **f32))
    p_m = torch.tensor([0.5, 0.1, 0.0], **f32)
    X_c = tlie.quat_rotate(tlie.quat_conj(q_m), X_w - p_m)
    pix = torch.stack([400.0 * X_c[0] / X_c[2] + 320.0,
                       400.0 * X_c[1] / X_c[2] + 240.0])
    w = WindowState.zeros(2, E=1, L=2, device=device)
    imu, ext, lm = w.imu, w.extrinsics, w.landmarks
    imu.q[0] = tlie.quat_mul(q_m, tlie.so3_exp_quat(
        torch.tensor([0.01, -0.01, 0.02], **f32)))
    imu.p[0] = p_m + torch.tensor([0.05, -0.04, 0.03], **f32)
    imu.active[0] = True
    ext.active[0] = ext.held[0] = True
    lm.pt[0, 0] = rho_gt * 1.3
    lm.active[0] = True
    fam = fc.InverseDepthUnaryReprojectionFactors.zeros(4, device=device)
    fam.active[0] = True
    fam.bearing[0] = bearing
    fam.pixel[0] = pix
    fam.intr[0] = torch.tensor([400.0, 400.0, 320.0, 240.0], **f32)
    fam.sqrt_info[0] = torch.eye(2, **f32)
    prior = fc.AbsolutePoseFactors.zeros(1, device=device)
    prior.active[0] = True
    prior.q0[0], prior.p0[0] = q_m, p_m
    prior.sqrt_info[0] = 1e3 * torch.eye(6, **f32)
    return w, (fam, prior), (None, None), rho_gt


# 15d's free-running session: the configuration of
# tests/test_threaded_pipeline.py:21-62 (LIO, lag 3 s, 32 states, LM <= 6
# steps, LIDAR initialization after 1.5 m; the structured 16 × 504 scene
# seen along an analytic trajectory; 100 Hz IMU, 5 Hz lidar, 6 s).
THREADED_P_BL = (0.05, 0.0, -0.08)
THREADED_S, THREADED_IMU_HZ, THREADED_LIDAR_HZ = 6.0, 100.0, 5.0
THREADED_ATE = 0.05               # tests/test_threaded_pipeline.py:88-89


def threaded_config():
    """The LocalMapperConfig of tests/test_threaded_pipeline.py::_cfg."""
    from beam_slam_tpu_torch.models.slam_initialization import InitParams
    from beam_slam_tpu_torch.pipeline.config import (CalibrationConfig,
                                                     LocalMapperConfig)
    return LocalMapperConfig(
        mode="LIO", lag_duration=3.0, max_states=32, max_iterations=6,
        init=InitParams(mode="LIDAR", min_trajectory_length_m=1.5,
                        min_observability=0.1),
        calibration=CalibrationConfig(
            q_baselink_lidar=np.array([1, 0, 0, 0], np.float32),
            p_baselink_lidar=np.asarray(THREADED_P_BL, np.float32)))


def threaded_feed(mapper, device, duration_s=THREADED_S, between=None):
    """Feed ``mapper`` the session of tests/test_threaded_pipeline.py::_feed
    on ``device``: per lidar period its IMU samples, then the scan of the
    structured scene seen from the true pose. ``between(kind)`` runs after
    each segment's IMU samples ("imu") and after its scan ("scan"): a sync
    mapper's tick, or a threaded mapper's join and tick. Returns the
    trajectory."""
    from beam_slam_tpu_torch.core import lie as tlie
    from beam_slam_tpu_torch.device import to_numpy
    from beam_slam_tpu_torch.lidar.cloud import synthetic_structured_scene
    from beam_slam_tpu_torch.utils.sim import AnalyticTrajectory
    scene = synthetic_structured_scene(n_rings=16, width=504, device=device)
    p_bl = torch.tensor(THREADED_P_BL, device=device)
    traj = AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2),
                              v_drift=(0.35, 0.05, 0.0),
                              amp_r=(0.1, 0.1, 0.15), device=device)
    n_seg = int(duration_s * THREADED_LIDAR_HZ)
    per = int(THREADED_IMU_HZ / THREADED_LIDAR_HZ)
    t_prev = 0.0
    for k in range(1, n_seg + 1):
        t = k / THREADED_LIDAR_HZ
        tm = t_prev + (np.arange(per) + 0.5) / THREADED_IMU_HZ
        smp = traj.sample(torch.tensor(tm, dtype=torch.float32,
                                       device=device))
        w, a = to_numpy(smp.w_body, smp.a_body)
        for i in range(per):
            mapper.on_imu(float(tm[i]), w[i], a[i])
        if between is not None:
            between("imu")
        g = traj.sample(torch.tensor([t], dtype=torch.float32,
                                     device=device))
        # lidar pose = baselink pose ∘ (identity rotation, P_BL)
        p_wl = g.p[0] + tlie.quat_rotate(g.q[0], p_bl)
        xyz = tlie.quat_rotate(tlie.quat_conj(g.q[0])[None, None],
                               scene.xyz - p_wl)
        grid = scene.replace(xyz=torch.where(scene.valid[..., None], xyz,
                                             torch.zeros_like(xyz)))
        mapper.on_scan(round(t, 6), grid)
        if between is not None:
            between("scan")
        t_prev = t
    return traj


def defer_notifications(mapper):
    """Make a LocalMapper deliver the graph-update notifications of its
    models (inertial, lidar and visual odometry) after ``tick()`` returns,
    in registration order, as the threaded mapper's spinners deliver them
    in lockstep (``ThreadedLocalMapper._route_graph_updates``); other
    subscribers (publishers) stay inline. The sync mapper delivers them
    inside the harvest, before the tick ingests and dispatches the next
    solve, so with inline delivery the two part after the first tick that
    harvests a solve. Returns the mapper."""
    owners = [mapper.io, getattr(mapper.io, "model", None), mapper.lo,
              getattr(mapper.lo, "registration", None), mapper.vo]
    deferred, routed = [], []
    for cb in mapper.smoother._on_update:
        owner = getattr(cb, "__self__", None)
        if owner is not None and any(owner is o for o in owners):
            routed.append(lambda sm, cb=cb: deferred.append((cb, sm)))
        else:
            routed.append(cb)
    mapper.smoother._on_update = routed
    tick = mapper.tick

    def deferred_tick():
        out = tick()
        while deferred:
            cb, sm = deferred.pop(0)
            cb(sm)
        return out
    mapper.tick = deferred_tick
    return mapper


def window_positions(mapper):
    """{stamp: position} of every state in the mapper's window."""
    sm = mapper.smoother
    return {t: sm.get_state(t)["p"].copy() for t in sm.current_stamps()}


def final_ate(mapper, traj):
    """The reference test's final-window ATE: every window state against
    the trajectory, after an SE(3) fit."""
    from beam_slam_tpu_torch.device import to_numpy
    from beam_slam_tpu_torch.utils.evaluation import ate_rmse
    stamps = mapper.smoother.current_stamps()
    est = np.stack([mapper.smoother.get_state(t)["p"] for t in stamps])
    gt = traj.sample(torch.tensor(stamps, dtype=torch.float32,
                                  device=traj.device))
    return ate_rmse(est, to_numpy(gt.p)[0], align="se3")


def _k1():
    from beam_slam_tpu_torch.ops import cholesky as chol
    return chol.cholesky_solve_batched


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _solve_trace(fn):
    """Where one solve's wall goes: ``fn`` once under the profiler, the
    card's activity only. Returns (wall ms, ms until the host had queued
    the whole solve, device ms of kernels and copies, device ops, K1's
    device ms, K1's launches), or None when the profiler lost the events
    three times (no K1 event seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            queued = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_dev = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        k1 = [e.time_range.elapsed_us() for e in on_dev
              if "chol_solve" in e.name]
        if k1:
            return (wall * 1e3, queued * 1e3,
                    sum(e.time_range.elapsed_us() for e in on_dev) / 1e3,
                    len(on_dev), sum(k1) / 1e3, len(k1))
    return None


def run_pgo(card="", device="cuda"):
    """15a: the coupled pose graph at 1000 keyframes (PGO_N) over factor
    shards: distributed_pgo.solve_distributed over PGO_SHARDS shards,
    multihost.solve_pgo_multihost over a PGO_HOSTS layout and solve_single,
    on the card (PGO_ITERS LM steps, K1 at (1, 6000) each), then
    solve_single on the CPU plain path. Held to the reference test's
    bounds; K1 timed at (1, 6000) by CUDA events and by the port's
    amortized timer, the library pair beside it; one more 1-shard solve
    under the profiler says where its wall goes (_solve_trace). Returns the
    K1 launches and the K1 row. ``device="cpu"`` rehearses the phase off
    the card (no kernel, no times, no trace)."""
    from beam_slam_tpu_torch.device import to_numpy
    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.parallel import distributed_pgo as dpgo
    from beam_slam_tpu_torch.parallel import multihost as mh
    from beam_slam_tpu_torch.parallel.sharded import Mesh
    from beam_slam_tpu_torch.utils import timing

    cuda = device == "cuda"
    state, fac, pri, p_gt = pgo_ring(device)
    solves = {}

    def run(label, fn, cuda=cuda):
        k1 = _k1()
        k1.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, c0, c1 = fn()
        q, p, c0, c1 = to_numpy(out.q, out.p, c0, c1)
        solves[label] = dict(
            out=out, p=p, c0=float(c0), c1=float(c1),
            wall=time.perf_counter() - t0, k1=k1.launches,
            gib=(torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                 else None))

    run("1 shard", lambda: dpgo.solve_single(state, fac, pri, PGO_ITERS))
    run(f"{PGO_SHARDS} shards", lambda: dpgo.solve_distributed(
        Mesh((dpgo.AXIS,), (PGO_SHARDS,), device), state, fac, pri,
        PGO_ITERS))
    run("{}x{}".format(*PGO_HOSTS), lambda: mh.solve_pgo_multihost(
        state, fac, pri, PGO_ITERS,
        mesh=mh.make_hybrid_mesh(*PGO_HOSTS, devices=[device])))
    launches = sum(s["k1"] for s in solves.values())
    run("CPU", lambda: dpgo.solve_single(state.to("cpu"), fac.to("cpu"),
                                         pri.to("cpu"), PGO_ITERS),
        cuda=False)
    # not the path's launches: the counts above are read already
    trace = _solve_trace(lambda: dpgo.solve_single(
        state, fac, pri, PGO_ITERS)) if cuda else None
    one = solves["1 shard"]
    gaps = {k: float(np.abs(s["p"] - one["p"]).max())
            for k, s in solves.items() if k != "1 shard"}
    truth = {k: float(np.linalg.norm(s["p"] - p_gt, axis=1).max())
             for k, s in solves.items()}
    ratio = {k: s["c1"] / s["c0"] for k, s in solves.items()}

    # K1 on the solved graph's damped system (the first step's λ), timed
    # by CUDA events in turns with the library pair, and by the port's
    # amortized timer; these launches are not the path's
    H, g, _ = dpgo._local_normal_eqs(one["out"], fac, pri)
    free_dof = torch.repeat_interleave(one["out"].free, dpgo.POSE_DOF)
    Hs, gs, _ = dpgo._damped_system(
        H, g, torch.tensor(1e-4, device=device), free_dof)
    Hs, gs = Hs[None].contiguous(), gs[None].contiguous()
    chol_k, plain = chol.cholesky_solve_batched, \
        chol.cholesky_solve_batched_reference
    x, info = chol_k(Hs, gs)
    x_ref, _ = plain(Hs, gs)
    err = float((x - x_ref).abs().max())
    ev_ms = lib_ms = am_ms = float("nan")
    if cuda:
        ev_ms, lib_ms = _paired_ms(lambda: chol_k(Hs, gs),
                                   lambda: plain(Hs, gs), reps=10)
        am_ms = timing.amortized_median_ms(chol_k, Hs, gs)
    bound, bound_by = _chol_bound(1, Hs.shape[-1])
    solve_desc = "; ".join(
        f"{k}: {s['wall']:.2f} s, {s['k1']} K1 launches"
        + (f", peak {s['gib']:.2f} GiB" if s["gib"] is not None else "")
        for k, s in solves.items())
    print(f"[15a] coupled pose graph, {PGO_N} keyframes (D = "
          f"{6 * PGO_N}), {fac.i.shape[0]} factors ({PGO_LOOPS} loop "
          f"closures), {PGO_ITERS} LM steps a solve: {solve_desc}; max|Δp| "
          f"against the card's 1-shard solve "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" m (bound {PGO_POS_TOL}); against the truth "
          + ", ".join(f"{k} {v:.2e}" for k, v in truth.items())
          + f" m (bound {PGO_GT_TOL}); final / initial cost "
          + ", ".join(f"{k} {v:.2e}" for k, v in ratio.items())
          + f" (bound {PGO_COST_RATIO}); K1 at "
          f"({Hs.shape[0]}, {Hs.shape[-1]}): "
          f"max|x-x_ref| {err:.3e} (bound "
          f"{X_TOL * float(x_ref.abs().max()):.3e}), CUDA events "
          f"{ev_ms:.4f} ms, amortized timer {am_ms:.4f} ms (within "
          f"{100 * abs(am_ms - ev_ms) / ev_ms:.1f}%, bound 10%), library "
          f"pair cholesky_ex + cholesky_solve {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}) ({card})", flush=True)
    if trace is not None:
        wall, queued, busy, n_ops, k1_ms, k1_n = trace
        print(f"[15a] one 1-shard solve under the profiler: wall {wall:.1f} "
              f"ms, the host had queued all of it at {queued:.1f} ms; "
              f"device time {busy:.2f} ms in {n_ops} device ops, idle "
              f"{100 * (1 - busy / wall):.1f}% of the wall; K1 {k1_ms:.2f} "
              f"ms in {k1_n} launches ({100 * k1_ms / busy:.1f}% of the "
              f"device time, {100 * k1_ms / wall:.1f}% of the wall), the "
              f"rest of the device {busy - k1_ms:.2f} ms ({card})",
              flush=True)
    elif cuda:
        print("[15a] one 1-shard solve under the profiler: the profiler "
              "lost its events; device time not measured", flush=True)
    if not (all(v <= PGO_POS_TOL for v in gaps.values())
            and all(v <= PGO_GT_TOL for v in truth.values())
            and all(v <= PGO_COST_RATIO for v in ratio.values())):
        raise RuntimeError("[15a] the coupled pose graph missed a bound")
    if cuda and not (int(info[0]) == 0
                     and err <= X_TOL * float(x_ref.abs().max())
                     and abs(am_ms - ev_ms) <= 0.1 * ev_ms
                     and all(s["k1"] == PGO_ITERS for k, s in solves.items()
                             if k != "CPU")):
        raise RuntimeError("[15a] K1 at (1, 6000) failed its checks")
    return dict(launches=launches,
                k1=dict(ms=ev_ms, am_ms=am_ms, plain_ms=lib_ms,
                        bound=(bound, bound_by), err=err,
                        launches=launches))


def run_sharded_ba(flagship, batch, card="", device="cuda"):
    """15b and 15c: the flagship window's BA over factor shards
    (distributed_ba.solve_distributed, K1 at (1, 640)) against phase 4's
    solve; the unary IDP problem card vs CPU; the sharded refinement step
    over phase 5's B windows (K1 at (B, 640)) against phase 5's batched
    solve. Returns the K1 launches."""
    from beam_slam_tpu_torch.device import to_numpy
    from beam_slam_tpu_torch.parallel import distributed_ba as dba
    from beam_slam_tpu_torch.parallel import sharded as tsh
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    k1 = _k1()
    options = gn.SolverOptions(max_iterations=10)

    # ---- 15b
    window, fams, out4, diag4 = (flagship[k] for k in
                                 ("window", "fams", "out", "diag"))
    k1.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    out_d, diag_d = dba.solve_distributed(
        dba.make_mesh(BATCH, devices=[device]), window, fams, LOSSES,
        options)
    c1_d, c1_4 = (float(c) for c in to_numpy(diag_d.final_cost,
                                             diag4.final_cost))
    wall = time.perf_counter() - t0
    launches = k1.launches
    act = window.landmarks.active
    gaps = dict(
        cost=abs(c1_d - c1_4) / c1_4,
        p=float((out_d.imu.p - out4.imu.p).abs().max()),
        q=float((out_d.imu.q - out4.imu.q).abs().max()),
        lm=float((out_d.landmarks.pt - out4.landmarks.pt)[act].abs().max()))
    idp = {}
    for side, dev in (("cuda", device), ("cpu", "cpu")):
        w, f, l, rho_gt = unary_idp_problem(dev)
        k1.launches = 0
        out, diag = gn.solve(w, f, l, gn.SolverOptions(max_iterations=15))
        idp[side] = (float(diag.final_cost), float(out.landmarks.pt[0, 0]))
        if side == "cuda":
            launches += k1.launches
    print(f"[15b] flagship BA over {BATCH} factor shards "
          f"(distributed_ba.solve_distributed, {options.max_iterations} LM "
          f"steps; {launches} K1 launches with the unary IDP solve's) "
          f"against phase 4's solve: final cost "
          f"{c1_d:.6g} / {c1_4:.6g} (rel gap {gaps['cost']:.2e}, bound "
          f"{BA_COST_RTOL}), max|Δp| {gaps['p']:.2e}, max|Δq| "
          f"{gaps['q']:.2e} (bound {BA_IMU_TOL}), active landmarks "
          f"{gaps['lm']:.2e} (bound {BA_LM_TOL}); wall {1e3 * wall:.1f} ms "
          f"against phase 4's {flagship['ms']:.1f} ms; unary IDP card / "
          f"CPU: final cost {idp['cuda'][0]:.2e} / {idp['cpu'][0]:.2e} "
          f"(bound {IDP_COST}), ρ {idp['cuda'][1]:.6f} / "
          f"{idp['cpu'][1]:.6f} (truth {rho_gt}, bound {IDP_RHO}; card vs "
          f"CPU {abs(idp['cuda'][1] - idp['cpu'][1]):.2e}, bound "
          f"{IDP_CARD_CPU}) ({card})", flush=True)
    if not (gaps["cost"] <= BA_COST_RTOL and gaps["p"] <= BA_IMU_TOL
            and gaps["q"] <= BA_IMU_TOL and gaps["lm"] <= BA_LM_TOL):
        raise RuntimeError("[15b] sharded BA disagrees with phase 4")
    if not (all(c < IDP_COST and abs(r - rho_gt) < IDP_RHO
                for c, r in idp.values())
            and abs(idp["cuda"][1] - idp["cpu"][1]) <= IDP_CARD_CPU):
        raise RuntimeError("[15b] the unary IDP problem failed its checks")

    # ---- 15c
    wins, fams_b, out_b = (batch[k] for k in ("windows", "fams", "out"))
    k1.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    out_c, diags_c, total = tsh.distributed_refinement_step(
        tsh.make_mesh(REFINE_SHARDS, devices=[device]), wins, fams_b,
        LOSSES, options)
    c0, c1, total = to_numpy(diags_c.initial_cost, diags_c.final_cost, total)
    wall = time.perf_counter() - t0
    launches_c = k1.launches
    dp = float((out_c.imu.p - out_b.imu.p).abs().max())
    total_gap = abs(float(total) - float(c1.sum())) / float(c1.sum())
    print(f"[15c] sharded refinement step over {REFINE_SHARDS} shards, "
          f"B = {len(c1)} flagship windows: every final cost <= its "
          f"initial ({bool((c1 <= c0).all())}; worst final / initial "
          f"{float((c1 / c0).max()):.2e}); max|Δp| against phase 5's "
          f"batched solve {dp:.2e} m (bound {REFINE_POS}); total "
          f"{float(total):.6g} = the sum of the final costs (rel gap "
          f"{total_gap:.1e}); {launches_c} K1 launches, wall "
          f"{1e3 * wall:.1f} ms ({card})", flush=True)
    if not (bool((c1 <= c0).all()) and dp <= REFINE_POS
            and total_gap <= 1e-6
            and (launches_c >= 1 or device != "cuda")):
        raise RuntimeError("[15c] the sharded refinement step failed")
    return dict(launches=launches + launches_c)


def _replay(mapper, frames, grids, threaded=False, tick=None):
    """Feed ``frames`` (phase 11's) to ``mapper``; a threaded mapper joins
    after each run of one stream's events. ``tick`` replaces the mapper's
    tick. Returns the ticks' harvested diagnostics (None where none)."""
    out = []
    for frame in frames:
        events = frame[:-1]
        for i, ev in enumerate(events):
            if ev[0] == "imu":
                mapper.on_imu(ev[1], ev[2], ev[3])
            elif ev[0] == "scan":
                mapper.on_scan(ev[1], grids[ev[1]])
            if threaded and (i + 1 == len(events)
                             or events[i + 1][0] != ev[0]):
                mapper.join(timeout=600.0)
        out.append((tick or mapper.tick)())
    return out


def run_threaded(lio_frames=None, card="", device="cuda",
                 duration_s=MAPPER_S):
    """15d: the threaded mapper on the card. Lockstep: phase 11's events
    (configs/lio.yaml but the ignition after LOCKSTEP_INIT_M of path, the
    vendored scan at 16 × 1800) up to the frame whose tick dispatches the
    third solve after the ignition's, through
    ThreadedLocalMapper(optimizer_thread=False) with a join after each
    stream's events, held against a sync LocalMapper that delivers its
    models' graph-update notifications after each tick, as the threaded
    mapper's spinners do (defer_notifications); publishers and diagnostics
    on the threaded mapper's smoother. Free-running: the JAX test's
    session with the optimizer thread. Returns the K1 and K2 launches.
    ``device="cpu"`` (and a shorter ``duration_s`` of events to draw from)
    rehearses the phase off the card."""
    from beam_slam_tpu_torch.obs import diagnostics as tdiag
    from beam_slam_tpu_torch.obs.publishers import (Odometry3DPublisher,
                                                    Path3DPublisher)
    from beam_slam_tpu_torch.ops import knn
    from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    from beam_slam_tpu_torch.pipeline.threaded import ThreadedLocalMapper
    k1 = _k1()
    dev = None if device == "cuda" else device   # entry points: the card

    def lockstep_config():
        cfg = _mapper_config("LIO")
        cfg.init.min_trajectory_length_m = LOCKSTEP_INIT_M
        return cfg
    if lio_frames is None:
        _, frames, grids, _, _ = _mapper_frames("LIO", duration_s, dev,
                                                through_log=False)
    else:
        frames, grids = lio_frames
    k1.launches = knn.knn_topk.launches = 0
    # PyTorch's deterministic algorithms for the two lockstep runs: with
    # index_add_'s float atomics two runs of one mapper on the card part by
    # more than the bound by this tick (the ignition solve amplifies the
    # sums' order); with them they do not part at all
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        oracle = defer_notifications(LocalMapper(lockstep_config(),
                                                 device=dev))
        n = 0
        for n, frame in enumerate(frames, 1):
            _replay(oracle, [frame], grids)
            if oracle.initialized and oracle.smoother.solve_count >= 4:
                break
        oracle.flush()
        t_oracle = time.perf_counter() - t0
        tm = ThreadedLocalMapper(lockstep_config(), device=dev,
                                 optimizer_thread=False).start()
        diag = tdiag.SmootherDiagnostics(tm.smoother)
        odom = Odometry3DPublisher(tm.smoother)
        path = Path3DPublisher(tm.smoother)
        fired = []
        odom.subscribe(lambda s: fired.append(
            ("odom", s.stamp, tm.smoother.current_stamps()[-1])))
        path.subscribe(lambda p: fired.append(
            ("path", [t for t, _, _ in p], tm.smoother.current_stamps())))
        t0 = time.perf_counter()
        harvested = _replay(tm, frames[:n], grids, threaded=True,
                            tick=lambda: diag.run_once_timed(run=tm.tick))
        tm.join(timeout=600.0)
        t_thr = time.perf_counter() - t0
        n_harv = sum(h is not None for h in harvested)
        odom_f = [f for f in fired if f[0] == "odom"]
        path_f = [f for f in fired if f[0] == "path"]
        rep = diag.report()
        problems = tdiag.validate_graph(tm.smoother)
        tm.stop()   # the window after T: both with their last solve
    finally:
        torch.use_deterministic_algorithms(was_det)
    a, b = window_positions(oracle), window_positions(tm)
    worst = (max(float(np.abs(a[t] - b[t]).max()) for t in a)
             if sorted(a) == sorted(b) else float("inf"))
    launches = dict(k1=k1.launches, k2=knn.knn_topk.launches)
    print(f"[15d] lockstep: the first {n} frames ({n * 0.1:.1f} s) of "
          f"phase 11's events (ignition after {LOCKSTEP_INIT_M} m) through "
          f"ThreadedLocalMapper("
          f"optimizer_thread=False) and the sync LocalMapper with deferred "
          f"notifications, both flushed, PyTorch's deterministic algorithms "
          f"on: {len(a)} window states, {tm.smoother.solve_count}"
          f" / {oracle.smoother.solve_count} solves dispatched, max|Δp| "
          f"{worst:.2e} m (bound {MAPPER_LOCKSTEP_TOL}); wall {t_oracle:.1f}"
          f" s / {t_thr:.1f} s; {n_harv} harvests, the odometry publisher "
          f"fired {len(odom_f)}, the path publisher {len(path_f)} times; "
          f"validate_graph {problems or 'clean'}; diagnostics: staleness "
          f"{rep['staleness_s']:.3f} s, cycle median "
          f"{1e3 * rep['cycle']['median']:.1f} ms, overruns "
          f"{rep['overruns']} ({card})", flush=True)
    if not (worst <= MAPPER_LOCKSTEP_TOL and tm.initialized
            and tm.smoother.solve_count == oracle.smoother.solve_count):
        raise RuntimeError("[15d] the lockstep threaded mapper disagrees")
    if not (len(odom_f) == len(path_f) == n_harv > 0
            and all(s == newest for _, s, newest in odom_f)
            and all(ts == cur for _, ts, cur in path_f)
            and not problems and np.isfinite(rep["staleness_s"])):
        raise RuntimeError("[15d] publishers / diagnostics failed")

    k1_0, k2_0 = k1.launches, knn.knn_topk.launches
    t0 = time.perf_counter()
    free = ThreadedLocalMapper(threaded_config(), device=dev).start()
    traj = threaded_feed(free, device)
    free.join(timeout=600.0)
    free.stop()
    wall = time.perf_counter() - t0
    ate = (final_ate(free, traj) if free.smoother.current_stamps()
           else float("inf"))   # never ignited: no window
    launches["k1"] += k1.launches - k1_0
    launches["k2"] += knn.knn_topk.launches - k2_0
    print(f"[15d] free-running: tests/test_threaded_pipeline.py's session "
          f"({THREADED_S} s, {THREADED_IMU_HZ:.0f} Hz IMU, "
          f"{THREADED_LIDAR_HZ:.0f} Hz lidar, 16 × 504) with the optimizer "
          f"thread: drops {free.dropped}, errors {free.errors}, "
          f"{free.smoother.solve_count} solves, final-window ATE {ate:.4f} "
          f"m after an SE(3) fit (bound {THREADED_ATE}); wall {wall:.1f} s; "
          f"in 15d K1 {launches['k1']} and K2 {launches['k2']} launches "
          f"({card})", flush=True)
    if not (free.initialized and all(v == 0 for v in free.dropped.values())
            and all(v == 0 for v in free.errors.values())
            and free.smoother.solve_count >= 3 and ate < THREADED_ATE):
        raise RuntimeError("[15d] the free-running threaded mapper failed")
    return dict(launches=launches)


def run_descriptors(card="", device="cuda"):
    """15e: descriptors and the image database, card against CPU, on 12b's
    seeded 640 × 480 texture and DESC_VIEWS shifted, noisy views of it."""
    from scipy import ndimage

    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.vision import descriptors as dsc
    from beam_slam_tpu_torch.vision import detector as det
    from beam_slam_tpu_torch.vision.image_database import (ImageDatabase,
                                                           train_vocabulary)
    rng = np.random.default_rng(DESC_SEED)
    base = _texture(np.random.default_rng(FRONT_END_SEED), tss.CAM.height,
                    tss.CAM.width, 600)
    views = [np.clip(ndimage.shift(base, rng.uniform(-6, 6, 2), order=1,
                                   mode="nearest")
                     + rng.normal(0, 2.0, base.shape), 0, 255)
             .astype(np.float32) for _ in range(DESC_VIEWS)]
    cfg = det.FastConfig(threshold=10, cell_size=24)
    out = {}
    t0 = time.perf_counter()
    for side, dev in (("cuda", device), ("cpu", "cpu")):
        descs = []
        for img in views:
            im = torch.as_tensor(img, device=dev)
            xy, _, v = det.detect(im, cfg)
            descs.append(dsc.compute(im, xy, v))
        out[side] = descs
        if side == "cuda":
            _sync(dev)
            ms = 1e3 * (time.perf_counter() - t0) / DESC_VIEWS
    same = total = 0
    for (dc, okc), (dp, okp) in zip(out["cuda"], out["cpu"]):
        if not torch.equal(okc.cpu(), okp):
            raise RuntimeError("[15e] the descriptors' masks differ")
        bc = dsc._unpack(dc.cpu()[okp])
        bp = dsc._unpack(dp[okp])
        same += int((bc == bp).sum())
        total += bc.numel()
    share = 1.0 - same / total
    matches = {}
    for side in ("cuda", "cpu"):
        d0, ok0 = out[side][0]
        matches[side] = [tuple(t.cpu() for t in dsc.match(d0, ok0, d, ok))
                         for d, ok in out[side][1:]]
    match_eq = all(torch.equal(ic, ip) and torch.equal(gc, gp)
                   for (ic, gc), (ip, gp) in zip(matches["cuda"],
                                                 matches["cpu"]))
    n_good = [int(g.sum()) for _, g in matches["cuda"]]
    # the trained vocabulary from the card's descriptors on both sides
    corpus = torch.cat([d for d, _ in out["cuda"]])
    valid = torch.cat([ok for _, ok in out["cuda"]])
    first = int(torch.nonzero(valid)[0])
    vocab = {side: train_vocabulary(corpus.to(dev), valid.to(dev),
                                    n_words=DESC_WORDS, n_iters=8,
                                    first=first)
             for side, dev in (("cuda", device), ("cpu", "cpu"))}
    vocab_eq = torch.equal(vocab["cuda"].cpu(), vocab["cpu"])
    answers = {}
    for side, dev in (("cuda", device), ("cpu", "cpu")):
        for name, db in (("default", ImageDatabase(device=dev)),
                         ("trained", ImageDatabase(vocab=vocab[side]))):
            half = DESC_VIEWS // 2
            for i, (d, ok) in enumerate(out[side][:half]):
                db.add_frame(float(i), d, ok)
            answers[side, name] = [
                [t for t, _ in db.query(d, ok, top_k=3, exclude_recent=0)]
                for d, ok in out[side][half:]]
    answers_eq = all(answers["cuda", n] == answers["cpu", n]
                     for n in ("default", "trained"))
    print(f"[15e] descriptors on {DESC_VIEWS} views of 12b's texture "
          f"(numpy seed {DESC_SEED}), card vs CPU: masks equal, bits "
          f"differing {100 * share:.3f}% (bound {100 * DESC_BITS:.1f}%), "
          f"matches to view 0 equal {match_eq} ({min(n_good)}–{max(n_good)}"
          f" good), trained vocabulary ({DESC_WORDS} words) equal "
          f"{vocab_eq}, query answers equal {answers_eq} (default and "
          f"trained vocabulary); detect + compute {ms:.1f} ms a view on the "
          f"card ({card})", flush=True)
    if not (share <= DESC_BITS and match_eq and vocab_eq and answers_eq):
        raise RuntimeError("[15e] descriptors / database disagree")


def run_calibration_viewer(card="", device="cuda"):
    """15f: the vendored scan projected into 12a's camera card vs CPU, and
    the artifacts written and read back."""
    from beam_slam_tpu_torch.obs.artifacts import read_ply
    from beam_slam_tpu_torch.obs.calibration_viewer import (
        project_scan_to_camera, write_calibration_artifacts)
    from beam_slam_tpu_torch.pipeline import sim_session as tss
    from beam_slam_tpu_torch.pipeline.config import CalibrationConfig
    cloud = _load_scan()
    ident = np.array([1, 0, 0, 0], np.float32)
    proj = {}
    for side, dev in (("cuda", device), ("cpu", "cpu")):
        grid = _observed_grid(cloud, ident, np.zeros(3, np.float32), dev)
        proj[side] = project_scan_to_camera(grid.xyz, grid.valid, tss.Q_BL,
                                           tss.P_BL, tss.Q_BC, tss.P_BC,
                                           tss.CAM)
    (uv_c, d_c, ok_c), (uv_p, d_p, ok_p) = proj["cuda"], proj["cpu"]
    px = float(np.abs(uv_c - uv_p)[ok_p].max()) if ok_p.any() else 0.0
    calib = CalibrationConfig(camera=tss.CAM, q_baselink_cam=tss.Q_BC,
                              p_baselink_cam=tss.P_BC,
                              q_baselink_lidar=tss.Q_BL,
                              p_baselink_lidar=tss.P_BL)
    with tempfile.TemporaryDirectory() as d:
        art = write_calibration_artifacts(d, calib, grid=grid)
        n_ply = len(read_ply(art["frames_ply"]))
        with open(art["overlay_ppm"], "rb") as f:
            magic, size = f.readline().strip(), f.readline().split()
    print(f"[15f] calibration viewer: the vendored scan at {N_RINGS} × "
          f"{WIDTH} into 12a's camera, card vs CPU: ok equal "
          f"{np.array_equal(ok_c, ok_p)} ({int(ok_p.sum())} points in the "
          f"image), max|Δuv| {px:.2e} px (bound {VIEWER_PX}); artifacts: "
          f"{n_ply} frame points, overlay {magic.decode()} "
          f"{b' '.join(size).decode()} with {art['n_projected']} points "
          f"({card})", flush=True)
    if not (np.array_equal(ok_c, ok_p) and ok_p.sum() > 100
            and px <= VIEWER_PX and magic == b"P6"
            and [int(x) for x in size] == [tss.CAM.width, tss.CAM.height]
            and n_ply > 0 and art["n_projected"] == int(ok_p.sum())):
        raise RuntimeError("[15f] the calibration viewer failed")


def run_completion_phase(card="", flagship=None, batch=None,
                         lio_frames=None, device="cuda", census=CENSUS,
                         mapper_s=MAPPER_S):
    """Phase 15. ``flagship`` / ``batch``: phase 4's and phase 5's problems
    and results (rebuilt here when not given); ``lio_frames``: phase 11's
    (frames, grids). Returns the K1 / K2 launches and K1's (1, 6000) row.
    ``device="cpu"`` with a small ``census`` and a short ``mapper_s``
    rehearses the phase off the card."""
    from beam_slam_tpu_torch.solver import batched as bs
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.utils import synthetic
    t_phase = time.perf_counter()
    options = gn.SolverOptions(max_iterations=10)
    if flagship is None:
        window, fams, _ = synthetic.build_lvio_window(
            torch.Generator().manual_seed(0), device=device, **census)
        t0 = time.perf_counter()
        out, diag = gn.solve(window, fams, LOSSES, options)
        _sync(device)
        flagship = dict(window=window, fams=fams, out=out, diag=diag,
                        ms=1e3 * (time.perf_counter() - t0))
    if batch is None:
        wins, fams_b, _ = synthetic.build_lvio_batch(
            torch.Generator().manual_seed(1), BATCH, device=device, **census)
        out_b, _ = bs.solve_batched_shared(wins, fams_b, LOSSES, options)
        batch = dict(windows=wins, fams=fams_b, out=out_b)
    pgo = run_pgo(card, device)
    ba = run_sharded_ba(flagship, batch, card, device)
    thr = run_threaded(lio_frames, card, device, mapper_s)
    run_descriptors(card, device)
    run_calibration_viewer(card, device)
    wall = time.perf_counter() - t_phase
    print(f"[15] phase 15 took {wall:.1f} s", flush=True)
    return dict(launches=dict(k1=pgo["launches"] + ba["launches"]
                              + thr["launches"]["k1"],
                              k2=thr["launches"]["k2"]),
                k1_6000=pgo["k1"])


def _start_phase(*args, module=None):
    """Start ``python3 chip_smoke.py <args>`` (or ``python3 -m <module>
    <args>``) in its own process, its standard output to a temporary file
    (its errors pass through)."""
    out = tempfile.TemporaryFile(mode="w+")
    cmd = ["-m", module] if module else [str(ROOT / "chip_smoke.py")]
    proc = subprocess.Popen([sys.executable, *cmd, *args], cwd=ROOT,
                            stdout=out, text=True)
    return dict(proc=proc, out=out, mode=" ".join(cmd[-1:] + list(args)),
                t0=time.perf_counter())


def _join_phase(run, tag, timeout=900, record='{"launches"'):
    """Wait for a phase started by _start_phase, print its lines
    indented, and return what its JSON line that starts with ``record``
    holds. Raises if it failed."""
    proc = run["proc"]
    t_wait = time.perf_counter()
    rc = proc.wait(timeout=timeout)
    run["out"].seek(0)
    lines = run["out"].read().splitlines()
    print(f"[{tag}] phase {tag} in its own process ({run['mode']}): "
          f"exit code {rc} after "
          f"{time.perf_counter() - run['t0']:.1f} s, this process waited "
          f"{time.perf_counter() - t_wait:.1f} s for it; its lines:",
          flush=True)
    rec = None
    for ln in lines:
        if ln.startswith(record):
            rec = json.loads(ln)
        else:
            print("  " + ln, flush=True)
    if rc != 0 or rec is None:
        raise RuntimeError(f"{tag}: {run['mode']} failed (exit code {rc})")
    return rec


def _stop_phase(run):
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()
    run["out"].close()


# ---- phase 16: the ATE runner's sessions (beam_slam_tpu_torch/tools/
# run_ate_benchmark.py: its CONFIGS and its sync oracle) at the duration of
# the JAX package's always-on envelope smoke (tests/test_envelope_e2e.py:
# 25-33), each in a side process. LIO also runs on the CPU. The two LIO
# sessions part by millimetres (1.5e-3–6.1e-3 m at each solve's newest
# state on an H100): on the session's scene float32 rounding alone moves a
# few of the ignition's registrations by up to ~1 cm, in the JAX package
# too (its own registration run op by op parts from its jitted run by
# 7.8e-3 m at 2.6 s; tests/test_torch_ate_runner.py). Their gap is
# printed; what is held is the card's LIO session in lockstep: each
# solve's problem solved again on the CPU, the window's states within the
# bounds
ATE_SMOKE_S = 6.0
ATE_BOUND = 0.05                    # tests/test_envelope_e2e.py:32
ATE_LIO_SOLVES = 20                 # tests/test_envelope_e2e.py:33
ATE_POS_TOL = ATE_ROT_TOL = 2e-3    # tests/test_torch_vio_session.py:47
ATE_SIDES = (("LIO", "cuda"), ("LIO", "cpu"), ("VIO", "cuda"),
             ("LVIO", "cuda"))
ATE_CPU_THREADS = 2                 # the host is shared with phases 10-12


def run_ate_one(mode, seconds, device):
    """One runner session in this process: one JSON line of its launches,
    its record, the newest state (stamp, p, q) after each solve and, for
    the card's LIO session, each solve's lockstep gap to the CPU: its
    problem solved again on the CPU (with its options), the largest
    position and rotation gap over the window's states."""
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.tools import run_ate_benchmark as ate
    if device == "cpu":
        torch.set_num_threads(ATE_CPU_THREADS)
    newest, lockstep, solve = {}, [], gn.solve

    def solve_in_lockstep(window, families, losses, options):
        out, diag = solve(window, families, losses, options)
        out_c, _ = solve(window.to("cpu"),
                         tuple(f.to("cpu") for f in families), losses,
                         options)
        act = out_c.imu.active
        dp = (out.imu.p.cpu() - out_c.imu.p)[act].norm(dim=1)
        q, q_c = out.imu.q.cpu()[act], out_c.imu.q[act]
        dr = [_so3_err(a.numpy(), b.numpy()) for a, b in zip(q, q_c)]
        lockstep.append([float(dp.max()), max(dr)])
        return out, diag
    if device == "cuda" and mode == "LIO":
        gn.solve = solve_in_lockstep
    try:
        rec = ate.run_mode(mode, seconds,
                           None if device == "cuda" else device,
                           newest=newest)
    finally:
        gn.solve = solve
    print(json.dumps({
        "launches": {"k1": rec["k1_launches"], "k2": rec["k2_launches"]},
        "ate": rec, "lockstep": lockstep,
        "newest": [[s, p, q] for s, (p, q) in sorted(newest.items())]}),
        flush=True)


def start_ate_phase(seconds=ATE_SMOKE_S):
    """Phase 16's sessions, each in its own process, started together."""
    return [_start_phase("ate-one", mode, str(seconds), device)
            for mode, device in ATE_SIDES]


def join_ate_phase(runs, card=""):
    """Wait for phase 16's sessions and hold them: each mode's ATE under
    the envelope smoke's bound with solves (LIO, on the card and on the
    CPU: more than it asks), and the card's LIO solves in lockstep with
    the CPU. Returns the card's K1 / K2 launches. Raises if a session
    failed or a check missed."""
    recs = {side: _join_phase(run, "16")
            for side, run in zip(ATE_SIDES, runs)}
    wall = time.perf_counter() - min(r["t0"] for r in runs)
    for (mode, device), r in recs.items():
        a = r["ate"]
        print(f"[16] {mode} on {device}: ATE {a['ate_rmse_m']:.6f} m over "
              f"{a['n_poses']} poses (bound {ATE_BOUND}), {a['n_solves']} "
              f"solves of {a['mean_solve_ms']:.1f} ms, wall "
              f"{a['wall_s']:.1f} s for {a['duration_s']} s (RTF "
              f"{a['rtf']:.2f}); K1 {a['k1_launches']} launches at (B, N) "
              f"{a['k1_shapes']}, K2 {a['k2_launches']}; peak memory "
              f"{a['peak_mem_gib']} GiB; idle {a['idle_share']} over a "
              f"frame of {a['idle_frame_ms']} ms ({card})", flush=True)
    bad = [side for side, r in recs.items()
           if not (r["ate"]["ate_rmse_m"] < ATE_BOUND
                   and r["ate"]["n_solves"] > 0)]
    bad += [(mode, device, "solves") for (mode, device), r in recs.items()
            if mode == "LIO" and r["ate"]["n_solves"] <= ATE_LIO_SOLVES]
    card_s, cpu_s = (recs[("LIO", side)]["newest"]
                     for side in ("cuda", "cpu"))
    same = [s[0] for s in card_s] == [s[0] for s in cpu_s]
    gaps = [(float(np.linalg.norm(np.subtract(a[1], b[1]))),
             _so3_err(a[2], b[2])) for a, b in zip(card_s, cpu_s)] \
        if same else [(float("inf"), float("inf"))]
    steps = recs[("LIO", "cuda")]["lockstep"]
    dp, dr = (max((g[i] for g in steps), default=float("inf"))
              for i in (0, 1))
    print(f"[16] LIO card vs CPU sessions: {len(card_s)} / {len(cpu_s)} "
          f"solves at {'the same' if same else 'other'} stamps, newest "
          f"states {max(g[0] for g in gaps):.3e} m / "
          f"{max(g[1] for g in gaps):.3e} rad apart (printed, not held); "
          f"in lockstep, {len(steps)} solves of the card's session solved "
          f"again on the CPU: window states within {dp:.3e} m / {dr:.3e} "
          f"rad (bounds {ATE_POS_TOL} / {ATE_ROT_TOL}); phase 16 took "
          f"{wall:.1f} s in {len(runs)} side processes", flush=True)
    if (bad or len(steps) != recs[("LIO", "cuda")]["ate"]["n_solves"]
            or not (dp <= ATE_POS_TOL and dr <= ATE_ROT_TOL)):
        raise RuntimeError(f"[16] the ATE sessions missed: {bad}, lockstep "
                           f"{len(steps)} solves, {dp} m / {dr} rad")
    cuda = [r for (_, dev), r in recs.items() if dev == "cuda"]
    return dict(launches=dict(k1=sum(r["launches"]["k1"] for r in cuda),
                              k2=sum(r["launches"]["k2"] for r in cuda)))


def run_ate(seconds, card=""):
    """``chip_smoke.py ate``: the runner's LIO, VIO and LVIO sessions of
    ``seconds`` each, three processes at once on the card, through the
    runner's command line. Prints each mode's JSON line; raises if a
    session failed or a mode's ATE is not under ATE_BOUND."""
    t0 = time.perf_counter()
    modes = ("LIO", "VIO", "LVIO")
    runs = [_start_phase("--modes", mode, "--duration", str(seconds),
                         module="beam_slam_tpu_torch.tools.run_ate_benchmark")
            for mode in modes]
    failed = []
    try:
        for mode, run in zip(modes, runs):
            try:
                rec = _join_phase(run, "ate", timeout=None, record='{"mode"')
            except RuntimeError as e:
                failed.append(f"{mode}: {e}")
                continue
            print(json.dumps(rec), flush=True)
            if not rec["ate_rmse_m"] < ATE_BOUND:
                failed.append(f"{mode}: ATE {rec['ate_rmse_m']} m")
    finally:
        for run in runs:
            _stop_phase(run)
    print(f"[ate] {seconds} s sessions took {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if failed:
        raise RuntimeError(f"[ate] failed or missed {ATE_BOUND} m: {failed}")


def main(only: str = "", seconds: float = 60.0) -> int:
    # ---- 1. require CUDA
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is visible")
    t_main = time.perf_counter()

    def lap(phases):   # the script's wall so far, for its time limit
        print(f"[time] phases {phases} done at "
              f"{time.perf_counter() - t_main:.1f} s", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}", flush=True)

    from beam_slam_tpu_torch.ops import cholesky as chol
    from beam_slam_tpu_torch.ops import knn, moments
    from beam_slam_tpu_torch.ops import nvcc_build
    from beam_slam_tpu_torch.solver import batched as bs
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    from beam_slam_tpu_torch.utils import synthetic

    # ---- 2. build K1, K2, K3 from csrc/, one nvcc each, all at once
    t0 = time.perf_counter()
    libs = {"bst_cholesky": chol, "bst_knn": knn, "bst_moments": moments}
    if only:
        wanted = dict(k1=(chol,), k2=(knn,), k3=(moments,),
                      smoother=(chol, knn), mapper=(chol, knn),
                      lvio=(chol, knn), localization=(chol, knn),
                      completion=(chol, knn), ate=(chol, knn),
                      **{"global": (chol, knn)})[
                          only.split("-")[0]]
        libs = {name: mod for name, mod in libs.items() if mod in wanted}
    built = nvcc_build.build_many([(name, mod.SOURCES)
                                   for name, mod in libs.items()])
    for mod in libs.values():
        mod.load_library()
    for name, (path, ptxas, secs) in built.items():
        regs = [ln.strip() for ln in ptxas.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[2] built {path.name} in {secs:.2f} s; ptxas: {regs}",
              flush=True)
    print(f"[2] all kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    if only == "smoother":  # the LIO+IMU session alone
        run_session(card)
        print(card)
        return 0
    if only == "mapper":  # the LIO LocalMapper alone
        run_mapper(card)
        print(card)
        return 0
    if only == "lvio":  # the vision phases alone
        vision = run_vision(card)
        print(json.dumps({"launches": vision["launches"]}))
        print(card)
        return 0
    if only == "global":  # global mapping alone
        run_global(card)
        print(card)
        return 0
    if only == "localization":  # 13a's map, then phase 14 on it
        run_localization(run_global(card, online_only=True)["loc"], card)
        print(card)
        return 0
    if only == "completion":  # phase 15 alone
        run_completion_phase(card)
        print(card)
        return 0
    if only == "ate":  # the runner's sessions of ``seconds``, at once
        run_ate(seconds, card)
        print(card)
        return 0
    if only in ("k2", "k3"):  # alone, on a map built at ground-truth poses
        (knn_checks if only == "k2" else moments_checks)(
            lio_knn_inputs("cuda"), card)
        print(card)
        return 0

    # ---- 3. K1 vs its plain version on the card
    k1 = cholesky_checks(card, deep=only == "k1")
    max_err, times = k1["max_err"], k1["times"]
    if only == "k1":
        print(card)
        return 0
    kernel, plain = chol.cholesky_solve_batched, \
        chol.cholesky_solve_batched_reference

    # ---- 4. flagship solve on the card
    t0 = time.perf_counter()
    window, fams, losses = synthetic.build_lvio_window(
        torch.Generator().manual_seed(0), device="cuda", **CENSUS)
    torch.cuda.synchronize()
    if losses != LOSSES:
        raise RuntimeError(f"unexpected losses {losses}")
    print(f"[4] flagship window built on the card in "
          f"{time.perf_counter() - t0:.2f} s: {window.num_dense_dof} dense "
          f"dof, {window.landmarks.capacity} landmarks, factors "
          f"{[int(f.active.sum()) for f in fams]}", flush=True)
    options = gn.SolverOptions(max_iterations=10)

    # K1 on the main path's own reduced system (first LM step)
    H0, g0, H_ll0, g_l0, W0, _ = gn.assemble_normal_equations(window, fams,
                                                               LOSSES)
    free = torch.cat([window.dense_free_mask(),
                      torch.zeros(1, dtype=torch.bool, device="cuda")])
    lm_free = window.landmarks.active & ~window.landmarks.held
    Hp, gp, _ = gn._damped_reduced_system(
        H0, g0, free, torch.tensor(options.initial_lambda, device="cuda"),
        H_ll0, g_l0, W0, lm_free)
    x, _ = kernel(Hp[None].contiguous(), gp[None].contiguous())
    x_ref, _ = plain(Hp[None].contiguous(), gp[None].contiguous())
    torch.cuda.synchronize()
    sys_err = float((x - x_ref).abs().max())
    if Hp.shape != (640, 640) or not sys_err <= X_TOL * float(
            x_ref.abs().max()):
        raise RuntimeError(f"K1 on the flagship reduced system {Hp.shape}: "
                           f"err {sys_err}")
    print(f"[4] K1 on the flagship reduced system {tuple(Hp.shape)}: "
          f"max|x-x_ref|={sys_err:.3e}", flush=True)

    chol.cholesky_solve_batched.launches = 0
    out, diag = gn.solve(window, fams, LOSSES, options)
    torch.cuda.synchronize()
    launches_flagship = chol.cholesky_solve_batched.launches
    c0, c1 = float(diag.initial_cost), float(diag.final_cost)
    it = int(diag.iterations)
    if not (torch.isfinite(diag.final_cost) and c1 < c0
            and launches_flagship >= max(it, 1)):
        raise RuntimeError(f"flagship solve: cost {c0} -> {c1}, {it} "
                           f"iterations, {launches_flagship} K1 launches")
    t0 = time.perf_counter()
    out_cpu, diag_cpu = gn.solve(window.to("cpu"),
                                 tuple(f.to("cpu") for f in fams), LOSSES,
                                 options)
    cpu_s = time.perf_counter() - t0
    c1_cpu = float(diag_cpu.final_cost)
    gap = abs(c1 - c1_cpu) / c1_cpu
    dp = float((out.imu.p.cpu() - out_cpu.imu.p).abs().max())
    print(f"[4] flagship solve: cost {c0:.6g} -> {c1:.6g} in {it} accepted "
          f"steps, {launches_flagship} K1 launches; CPU plain path "
          f"{c1_cpu:.6g} (rel gap {gap:.2e}, bound {COST_RTOL}; max|dp| "
          f"{dp:.2e} m, bound {DP_TOL}; {cpu_s:.1f} s on the host)",
          flush=True)
    if not (gap <= COST_RTOL and dp <= DP_TOL):
        raise RuntimeError(f"flagship solve on the card vs CPU: final cost "
                           f"{c1} vs {c1_cpu}, max|dp| {dp}")
    solve_ms = _wall_ms(lambda: gn.solve(window, fams, LOSSES, options), 5)
    print(f"[4] flagship solve: median {solve_ms:.2f} ms over 5 "
          f"({options.max_iterations} LM steps, {card})", flush=True)
    flagship = dict(window=window, fams=fams, out=out, diag=diag,
                    ms=solve_ms)

    # ---- 5. shared-topology batched solve on the card
    wins, fams_b, losses_b = synthetic.build_lvio_batch(
        torch.Generator().manual_seed(1), BATCH, device="cuda", **CENSUS)
    bs.assert_shared_topology(fams_b)
    chol.cholesky_solve_batched.launches = 0
    out_b, diag_b = bs.solve_batched_shared(wins, fams_b, losses_b, options)
    torch.cuda.synchronize()
    launches_batched = chol.cholesky_solve_batched.launches
    if not (bool(torch.isfinite(diag_b.final_cost).all())
            and bool((diag_b.final_cost < diag_b.initial_cost).all())
            and launches_batched >= 1):
        raise RuntimeError(f"batched solve: {diag_b.initial_cost.tolist()} -> "
                           f"{diag_b.final_cost.tolist()}, "
                           f"{launches_batched} K1 launches")
    batch_ms = _wall_ms(
        lambda: bs.solve_batched_shared(wins, fams_b, losses_b, options), 3)
    print(f"[5] batched B={BATCH}: every window's cost drops "
          f"(max final/initial "
          f"{float((diag_b.final_cost / diag_b.initial_cost).max()):.2e}), "
          f"{launches_batched} K1 launches; median {batch_ms:.2f} ms over 3 "
          f"({BATCH / batch_ms * 1e3:.1f} windows/s, {card})", flush=True)
    batch = dict(windows=wins, fams=fams_b, out=out_b)

    # ---- 6.-9. the LIO front end at full width (K2, K3)
    lio = run_lio("cuda", card=card)
    registration_card_vs_cpu(lio)
    registration_stages(lio, card=card)
    kc = kernel_checks(lio, card=card)
    run_pipelined(lio, card=card)
    k3_launches = run_radius(lio)
    lap("1-9")

    # ---- 12. the LVIO and VIO LocalMappers, the image front end (K1, K2),
    # in a second process beside phases 10 and 11: it needs nothing of the
    # phases before it, each process holds the host in its own GIL while
    # the card idles ~98% under a mapper, and the script's wall must stay
    # within its limit. Started after the kernels' times of phases 3–9 and
    # joined before phase 13's, so those run with the card to themselves.
    # ---- 16. the ATE runner's sessions (K1, K2), each in a side process
    # beside them for the same reasons
    vision_run = _start_phase("lvio")
    ate_runs = start_ate_phase()
    try:
        # ---- 10. the LIO+IMU session of the fixed-lag smoother (K1, K2)
        sess = run_session(card)
        lap("10")

        # ---- 11. the LIO LocalMapper of configs/lio.yaml (K1, K2)
        mapper = run_mapper(card)
        lap("11")

        vision = _join_phase(vision_run, "12")
        lap("12")
        ate = join_ate_phase(ate_runs, card)
        lap("16")
    finally:
        for run in [vision_run, *ate_runs]:
            _stop_phase(run)

    # ---- 13. global mapping and the map refinement (K1, K2)
    glob = run_global(card)
    lap("13")

    # ---- 14. localization: MultiScan, the tracker on 13a's map (K1, K2)
    local = run_localization(glob["loc"], card)
    lap("14")

    # ---- 15. the coupled PGO and BA over factor shards, the sharded
    # refinement step, the threaded mapper, descriptors and the image
    # database, the calibration viewer (K1, K2)
    comp = run_completion_phase(card, flagship, batch,
                                (mapper["frames"], mapper["grids"]))
    lap("15")

    # ---- records (K2 at the surface shape, the larger of the two)
    kb1, kb1_by = _chol_bound(1, 640)
    k2s = kc["k2"]["times"]["surfaces"]
    k3s = kc["k3"]["times"]["surfaces"]
    print(json.dumps({"kernels": [{
        "name": "cholesky_solve_batched", "route": "cuda",
        # two schedules: the line's times are the cluster schedule's at
        # (1, 640); the grid schedule carries the path's (1, N ≥ 896)
        "source": "beam_slam_tpu_torch/csrc/cholesky.cu + "
                  "beam_slam_tpu_torch/csrc/cholesky_grid.cu",
        "replaces": "beam_slam_tpu/ops/pallas_cholesky.py:226",
        "launches": (launches_flagship + launches_batched
                     + sess["launches"]["k1"] + mapper["launches"]["k1"]
                     + vision["launches"]["k1"] + glob["launches"]["k1"]
                     + local["launches"]["k1"] + comp["launches"]["k1"]
                     + ate["launches"]["k1"]),
        "max_abs_err": max_err, "ms": times[1][0], "plain_ms": times[1][1],
        "bound_ms": kb1, "bound_by": kb1_by,
        # the plain version is the library pair cholesky_ex + cholesky_solve
        "library_ms": times[1][1],
    }, {
        "name": "knn_topk", "route": "cuda",
        "source": "beam_slam_tpu_torch/csrc/knn.cu",
        "replaces": "beam_slam_tpu/ops/pallas_knn.py:110",
        "launches": (lio["launches"] + sess["launches"]["k2"]
                     + mapper["launches"]["k2"] + vision["launches"]["k2"]
                     + glob["launches"]["k2"] + local["launches"]["k2"]
                     + comp["launches"]["k2"] + ate["launches"]["k2"]),
        "max_abs_err": kc["k2"]["err"],
        "ms": k2s["ms"], "plain_ms": k2s["plain"],
        "bound_ms": k2s["bound"][0], "bound_by": k2s["bound"][1],
        "library_ms": k2s["lib"],
    }, {
        "name": "radius_moments", "route": "cuda",
        "source": "beam_slam_tpu_torch/csrc/moments.cu",
        "replaces": "beam_slam_tpu/ops/pallas_moments.py:79",
        "launches": k3_launches, "max_abs_err": kc["k3"]["err"],
        "ms": k3s["ms"], "plain_ms": k3s["plain"],
        "bound_ms": k3s["bound"][0], "bound_by": k3s["bound"][1],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["knn-counts"]:
        knn_counts((sys.argv[2:] or ["cuda"])[0])
        sys.exit(0)
    if sys.argv[1:2] == ["ate-one"] and len(sys.argv) == 5:
        run_ate_one(sys.argv[2], float(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["ate"] and len(sys.argv) <= 3:
        sys.exit(main("ate", float((sys.argv[2:] or [60.0])[0])))
    if sys.argv[1:] not in ([], ["k1"], ["k2"], ["k3"], ["smoother"],
                            ["mapper"], ["lvio"], ["global"],
                            ["localization"], ["completion"]):
        sys.exit(f"usage: {sys.argv[0]} [k1 | k2 | k3 | smoother | mapper | "
                 f"lvio | global | localization | completion | "
                 f"ate [seconds] | ate-one MODE SECONDS cuda|cpu | "
                 f"knn-counts [cpu|cuda]]")
    sys.exit(main(only=(sys.argv[1:] or [""])[0]))
