"""Synthetic full-pipeline session runner — drives the LocalMapper with
simulated IMU / camera / lidar streams at configurable rates and evaluates
ATE against the analytic ground truth (port of
:mod:`beam_slam_tpu.pipeline.sim_session`).

The sessions of the reference's envelope (lvio.yaml:2-3 — 10 s lag, 200 Hz
IMU, 20 Hz camera, 10 Hz VLP-16) on the analytic trajectory: LIO, VIO (no
lidar; the ignition from an external pose stream) and LVIO. The camera
sees a seeded landmark corridor through the sim's pinhole camera; its
draws and noise come from ``numpy.random.default_rng(seed)`` in the
reference's order, so both packages give the same stream.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from beam_slam_tpu_torch.core import lie
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.device import resolve, to_device, to_numpy
from beam_slam_tpu_torch.lidar.cloud import synthetic_structured_scene
from beam_slam_tpu_torch.models.slam_initialization import InitParams
from beam_slam_tpu_torch.models.visual_feature_tracker import \
    CameraMeasurement
from beam_slam_tpu_torch.pipeline.config import (CalibrationConfig,
                                                 LocalMapperConfig)
from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
from beam_slam_tpu_torch.utils import sim
from beam_slam_tpu_torch.utils.evaluation import ate_rmse
from beam_slam_tpu_torch.vision.camera import PinholeRadtan

CAM = PinholeRadtan(400.0, 400.0, 320.0, 240.0)
# T_BASELINK_CAMERA of the synthetic rig: camera z forward along body x
Q_BC = lie_np.matrix_to_quat(np.asarray(
    [[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32))
P_BC = np.asarray([0.1, 0.0, 0.05], np.float32)
# T_BASELINK_LIDAR of the synthetic rig
Q_BL = np.array([1, 0, 0, 0], np.float32)
P_BL = np.asarray([0.05, 0.0, -0.08], np.float32)
V_DRIFT = (0.35, 0.05, 0.0)


@dataclasses.dataclass
class SessionResult:
    mode: str
    duration_s: float
    ate_rmse_m: float
    n_poses: int
    n_solves: int
    mean_solve_ms: float
    wall_s: float
    counters: Dict[str, int]


def _trajectory(device):
    return sim.AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2), v_drift=V_DRIFT,
                                  amp_r=(0.1, 0.1, 0.15), device=device)


def _landmarks(rng, duration_s: float) -> np.ndarray:
    """The camera's landmark field: it populates the whole drift corridor
    (the trajectory advances v_drift[0]·duration metres in x) at constant
    density, so the camera always has fresh features ahead of it."""
    corridor = 7.0 + V_DRIFT[0] * duration_s
    n_lm = max(120, int(round(120 * corridor / 7.0)))
    lx = rng.uniform(4.0, 4.0 + corridor, n_lm)
    # centre the lateral band on the drifted path (y advances vy/vx per x)
    ly = (V_DRIFT[1] / max(V_DRIFT[0], 1e-9)) * lx \
        + rng.uniform(-4.5, 4.5, n_lm)
    return np.stack([lx, ly, rng.uniform(-2.2, 2.2, n_lm)],
                    axis=1).astype(np.float32)


def _camera_obs(q_wb, p_wb, lms, rng):
    """The landmarks one or more body poses see (q_wb [F, 4], p_wb [F, 3]):
    range-gated and capped like a real tracker (the nearest 150 within
    12 m), with 0.3 px of noise. Returns [(ids, pix)] per pose."""
    q_wc = lie_np.quat_mul(q_wb, Q_BC[None, :])
    p_wc = p_wb + lie_np.quat_rotate(q_wb, P_BC[None, :])
    X_c = lie_np.quat_rotate(lie_np.quat_conj(q_wc)[:, None, :],
                             lms[None, :, :] - p_wc[:, None, :])
    uv, valid = CAM.project(torch.from_numpy(np.ascontiguousarray(X_c)))
    uv, valid = uv.numpy(), valid.numpy() & (X_c[..., 2] < 12.0)
    out = []
    for f in range(len(q_wb)):
        ids = np.nonzero(valid[f])[0].astype(np.int64)
        if ids.size > 150:
            ids = ids[np.argsort(X_c[f, ids, 2])[:150]]
            ids = np.sort(ids)
        pix = uv[f, ids] + rng.standard_normal(
            (ids.size, 2)).astype(np.float32) * 0.3
        out.append((ids, pix.astype(np.float32)))
    return out


def _noisy_pose(q_gt, p_gt, rng):
    """External odometry for FRAMEINIT: a noisy ground-truth pose."""
    qn = lie_np.quat_mul(q_gt, lie_np.so3_exp_quat(
        rng.standard_normal(3).astype(np.float32) * 0.002))
    return qn, p_gt + rng.standard_normal(3).astype(np.float32) * 0.005


def generate_session_events(mode: str = "LVIO", duration_s: float = 20.0,
                            imu_hz: float = 200.0, cam_hz: float = 20.0,
                            lidar_hz: float = 10.0, seed: int = 11,
                            scene=None, device=None):
    """Pre-generate the full sensor stream for a session (same trajectory,
    scene, landmark corridor and noise draws as ``run_synthetic_session``)
    so a caller can feed a mapper and time only the pipeline. The
    trajectory is sampled and the scans live on ``device`` (the card unless
    asked otherwise).

    Returns (traj, events, n_frames) with events a time-sorted list of
    ("imu", t, w, a) / ("scan", t, grid) / ("cam", CameraMeasurement) /
    ("pose", t, q, p) / ("tick", t) tuples mirroring the online loop's
    feed order. ``seed`` draws the camera's landmarks and noise and the
    pose stream's noise, so a LIO stream does not depend on it.
    """
    rng = np.random.default_rng(seed)
    device = resolve(device)
    traj = _trajectory(device)
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504, device=device)
    use_cam = mode in ("VIO", "LVIO")
    use_lidar = mode in ("LIO", "LVIO")
    lms = _landmarks(rng, duration_s)

    tick_hz = cam_hz if use_cam else lidar_hz
    dt_frame = 1.0 / tick_hz
    n_frames = int(duration_s * tick_hz)
    n_imu = max(int(imu_hz / tick_hz), 1)

    # one batched trajectory sample for the whole stream
    frame_t = (np.arange(1, n_frames + 1) * dt_frame)
    steps = (np.arange(n_imu) + 0.5) / n_imu * dt_frame
    imu_t = (frame_t - dt_frame)[:, None] + steps[None, :]      # [F, n_imu]
    s_all = traj.sample(torch.tensor(imu_t.reshape(-1), dtype=torch.float32,
                                     device=device))
    g_all = traj.sample(torch.tensor(frame_t, dtype=torch.float32,
                                     device=device))
    w_all, a_all, gq, gp = to_numpy(s_all.w_body, s_all.a_body, g_all.q,
                                    g_all.p)
    w_all = w_all.reshape(n_frames, n_imu, 3)
    a_all = a_all.reshape(n_frames, n_imu, 3)

    # every scan by one host transform of the scene
    scan_every = 1 if not use_cam else max(int(tick_hz / lidar_hz), 1)
    q_wl = lie_np.quat_mul(gq, Q_BL[None, :])
    p_wl = gp + lie_np.quat_rotate(gq, P_BL[None, :])
    sxyz, svalid = to_numpy(scene.xyz, scene.valid)
    # every frame's camera observations at once (the noise drawn frame by
    # frame, before the pose stream's)
    cam_all = _camera_obs(gq, gp, lms, rng) if use_cam else None
    events = []
    for k in range(1, n_frames + 1):
        t = float(frame_t[k - 1])
        for i in range(n_imu):
            events.append(("imu", float(imu_t[k - 1, i]),
                           w_all[k - 1, i], a_all[k - 1, i]))
        if use_lidar and k % scan_every == 0:
            xyz = lie_np.quat_rotate(
                lie_np.quat_conj(q_wl[k - 1])[None, None],
                sxyz - p_wl[k - 1])
            xyz = np.where(svalid[..., None], xyz, 0.0).astype(np.float32)
            events.append(("scan", round(t, 6),
                           scene.replace(xyz=to_device(xyz, device))))
        if not use_lidar:
            qn, pn = _noisy_pose(gq[k - 1], gp[k - 1], rng)
            events.append(("pose", round(t, 6), qn, pn))
        if use_cam:
            ids, pix = cam_all[k - 1]
            events.append(("cam", CameraMeasurement(round(t, 6), ids, pix,
                                                    pix)))
        events.append(("tick", t))
    return traj, events, n_frames


def run_synthetic_session(mode: str = "LVIO", duration_s: float = 20.0,
                          lag_s: float = 10.0, imu_hz: float = 200.0,
                          cam_hz: float = 20.0, lidar_hz: float = 10.0,
                          max_states: int = 64, max_iterations: int = 8,
                          seed: int = 11, scene=None, on_tick=None,
                          true_landmarks_out=None, config_tweak=None,
                          device=None) -> SessionResult:
    """One full pipeline session at the given envelope, on ``device`` (the
    card unless asked otherwise). ``mode`` selects which sensors feed the
    local mapper (LIO: no camera; VIO: no lidar — the ignition comes from a
    noisy ground-truth pose stream, FRAMEINIT; LVIO: all).

    ``on_tick(mapper, t, traj)`` runs after every frame tick — the
    instrumentation hook for accuracy diagnosis. ``true_landmarks_out`` (a
    list) receives the ground-truth landmark array so callers can score the
    estimated map. ``config_tweak(cfg)`` edits the configuration before the
    mapper is built."""
    rng = np.random.default_rng(seed)
    device = resolve(device)
    traj = _trajectory(device)
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504, device=device)
    use_cam = mode in ("VIO", "LVIO")
    use_lidar = mode in ("LIO", "LVIO")
    lms = _landmarks(rng, duration_s)
    if true_landmarks_out is not None:
        true_landmarks_out.append(lms)
    cfg = LocalMapperConfig(
        mode=mode, lag_duration=lag_s, max_states=max_states,
        max_landmarks=256, max_reprojection_factors=4096,
        max_iterations=max_iterations,
        init=InitParams(mode="LIDAR", min_trajectory_length_m=1.5,
                        min_observability=0.1),
        calibration=CalibrationConfig(
            camera=CAM if use_cam else None,
            q_baselink_cam=Q_BC if use_cam else None,
            p_baselink_cam=P_BC if use_cam else None,
            q_baselink_lidar=Q_BL, p_baselink_lidar=P_BL,
            imu_hz=imu_hz, camera_hz=cam_hz, lidar_hz=lidar_hz))
    if config_tweak is not None:
        config_tweak(cfg)
    mapper = LocalMapper(cfg, device=device)
    q_bl = torch.as_tensor(Q_BL, device=device)
    p_bl = torch.as_tensor(P_BL, device=device)

    def scan_from_pose(q_wb, p_wb):
        q_wl = lie.quat_mul(q_wb, q_bl)
        p_wl = p_wb + lie.quat_rotate(q_wb, p_bl)
        xyz = lie.quat_rotate(lie.quat_conj(q_wl)[None, None],
                              scene.xyz - p_wl)
        return scene.replace(xyz=torch.where(scene.valid[..., None], xyz,
                                             torch.zeros_like(xyz)))

    # drive on the camera clock (or lidar clock for LIO)
    tick_hz = cam_hz if use_cam else lidar_hz
    dt_frame = 1.0 / tick_hz
    n_frames = int(duration_s * tick_hz)
    n_imu = max(int(imu_hz / tick_hz), 1)
    est: Dict[float, np.ndarray] = {}
    t_prev = 0.0
    t_wall0 = time.perf_counter()
    for k in range(1, n_frames + 1):
        t = k * dt_frame
        tm = t_prev + (np.arange(n_imu) + 0.5) * (t - t_prev) / n_imu
        s = traj.sample(torch.tensor(tm, dtype=torch.float32, device=device))
        w, a = to_numpy(s.w_body, s.a_body)
        for i in range(n_imu):
            mapper.on_imu(float(tm[i]), w[i], a[i])
        gk = traj.sample(torch.tensor([t], dtype=torch.float32,
                                      device=device))
        if use_lidar and (not use_cam
                          or k % max(int(tick_hz / lidar_hz), 1) == 0):
            mapper.on_scan(round(t, 6), scan_from_pose(gk.q[0], gk.p[0]))
        if not use_lidar or (use_cam and mapper.initialized):
            q_gt, p_gt = to_numpy(gk.q[0], gk.p[0])
        if not use_lidar:
            qn, pn = _noisy_pose(q_gt, p_gt, rng)
            mapper.on_pose(round(t, 6), qn, pn)
        if use_cam and mapper.initialized:
            (ids, pix), = _camera_obs(q_gt[None], p_gt[None], lms, rng)
            mapper.on_camera_measurement(
                CameraMeasurement(round(t, 6), ids, pix, pix))
        mapper.tick()
        if mapper.initialized:
            stamps = mapper.smoother.current_stamps()
            if stamps:
                st = mapper.smoother.get_state(stamps[-1])
                est[stamps[-1]] = st["p"].copy()
        if on_tick is not None:
            on_tick(mapper, t, traj)
        t_prev = t
    wall = time.perf_counter() - t_wall0

    if not mapper.initialized or len(est) < 5:
        raise RuntimeError(
            f"{mode} session failed to initialize/track ({len(est)} poses)")
    stamps_e = sorted(est.keys())
    est_p = np.stack([est[t] for t in stamps_e])
    gt_at = traj.sample(torch.tensor(stamps_e, dtype=torch.float32,
                                     device=device))
    rmse = float(ate_rmse(est_p, to_numpy(gt_at.p)[0], align="se3"))
    sm = mapper.smoother
    return SessionResult(
        mode=mode, duration_s=duration_s, ate_rmse_m=rmse,
        n_poses=len(stamps_e), n_solves=sm.solve_count,
        mean_solve_ms=1e3 * sm.total_solve_time / max(sm.solve_count, 1),
        wall_s=wall, counters=dict(sm.counters))
