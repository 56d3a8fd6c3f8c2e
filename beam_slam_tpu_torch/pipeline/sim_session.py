"""Synthetic full-pipeline session runner — drives the LocalMapper with
simulated IMU and lidar streams and evaluates ATE against the analytic
ground truth (port of :mod:`beam_slam_tpu.pipeline.sim_session`, LIO mode).

The session of the reference's envelope (lvio.yaml:2-3 — 200 Hz IMU, 10 Hz
VLP-16) on the analytic trajectory. LIO is ported; the camera streams of
VIO and LVIO come with the vision slice of the port and raise until then.
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
from beam_slam_tpu_torch.pipeline.config import (CalibrationConfig,
                                                 LocalMapperConfig)
from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
from beam_slam_tpu_torch.utils import sim
from beam_slam_tpu_torch.utils.evaluation import ate_rmse

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


def _lio_only(mode: str):
    if mode != "LIO":
        raise NotImplementedError(
            f"{mode} sessions need the camera stream, which is ported with "
            "the vision slice (slice 5); the port runs LIO")


def _trajectory(device):
    return sim.AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2), v_drift=V_DRIFT,
                                  amp_r=(0.1, 0.1, 0.15), device=device)


def generate_session_events(mode: str = "LIO", duration_s: float = 20.0,
                            imu_hz: float = 200.0, cam_hz: float = 20.0,
                            lidar_hz: float = 10.0, seed: int = 11,
                            scene=None, device=None):
    """Pre-generate the full sensor stream for a session (same trajectory,
    scene and scan schedule as ``run_synthetic_session``) so a *driver* can
    feed a mapper and time only the pipeline. The trajectory is sampled and
    the scans live on ``device`` (the card unless asked otherwise).

    Returns (traj, events, n_frames) with events a time-sorted list of
    ("imu", t, w, a) / ("scan", t, grid) / ("tick", t) tuples mirroring the
    online loop's feed order. ``seed`` draws only the camera's landmarks and
    noise, so a LIO stream does not depend on it.
    """
    _lio_only(mode)
    del cam_hz, seed
    device = resolve(device)
    traj = _trajectory(device)
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504, device=device)

    dt_frame = 1.0 / lidar_hz
    n_frames = int(duration_s * lidar_hz)
    n_imu = max(int(imu_hz / lidar_hz), 1)

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
    q_wl = lie_np.quat_mul(gq, Q_BL[None, :])
    p_wl = gp + lie_np.quat_rotate(gq, P_BL[None, :])
    sxyz, svalid = to_numpy(scene.xyz, scene.valid)
    events = []
    for k in range(1, n_frames + 1):
        t = float(frame_t[k - 1])
        for i in range(n_imu):
            events.append(("imu", float(imu_t[k - 1, i]),
                           w_all[k - 1, i], a_all[k - 1, i]))
        xyz = lie_np.quat_rotate(lie_np.quat_conj(q_wl[k - 1])[None, None],
                                 sxyz - p_wl[k - 1])
        xyz = np.where(svalid[..., None], xyz, 0.0).astype(np.float32)
        events.append(("scan", round(t, 6),
                       scene.replace(xyz=to_device(xyz, device))))
        events.append(("tick", t))
    return traj, events, n_frames


def run_synthetic_session(mode: str = "LIO", duration_s: float = 20.0,
                          lag_s: float = 10.0, imu_hz: float = 200.0,
                          cam_hz: float = 20.0, lidar_hz: float = 10.0,
                          max_states: int = 64, max_iterations: int = 8,
                          seed: int = 11, scene=None, on_tick=None,
                          config_tweak=None, device=None) -> SessionResult:
    """One full LIO pipeline session at the given envelope, on ``device``
    (the card unless asked otherwise).

    ``on_tick(mapper, t, traj)`` runs after every frame tick — the
    instrumentation hook for accuracy diagnosis. ``config_tweak(cfg)``
    edits the configuration before the mapper is built."""
    _lio_only(mode)
    del cam_hz, seed
    device = resolve(device)
    traj = _trajectory(device)
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504, device=device)
    cfg = LocalMapperConfig(
        mode=mode, lag_duration=lag_s, max_states=max_states,
        max_landmarks=256, max_reprojection_factors=4096,
        max_iterations=max_iterations,
        init=InitParams(mode="LIDAR", min_trajectory_length_m=1.5,
                        min_observability=0.1),
        calibration=CalibrationConfig(
            q_baselink_lidar=Q_BL, p_baselink_lidar=P_BL, imu_hz=imu_hz,
            lidar_hz=lidar_hz))
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

    # drive on the lidar clock
    dt_frame = 1.0 / lidar_hz
    n_frames = int(duration_s * lidar_hz)
    n_imu = max(int(imu_hz / lidar_hz), 1)
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
        mapper.on_scan(round(t, 6), scan_from_pose(gk.q[0], gk.p[0]))
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
