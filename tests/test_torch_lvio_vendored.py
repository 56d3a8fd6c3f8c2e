"""The LVIO mapper of configs/lvio.yaml on the vendored VLP-16 scan: the port
(beam_slam_tpu_torch.pipeline) against the JAX reference, on the CPU.
Slow: about 15 minutes a package for 8.5 s of events.

Both mappers get the reference's ``generate_session_events`` in LVIO mode
(seed 11, 200 Hz IMU, the landmark corridor at 20 Hz, the lidar at 10 Hz;
the events carried to the port by the bridge) with every scan replaced by
the vendored 16 × 1800 scan seen from that scan's lidar pose, as
``chip_smoke.py`` phase 11 builds its scans; ``configs/lvio.yaml`` as it
stands with the sim's rig: LIDAR initialization at 3.5 m, the pipelined
scan-to-map strategy, the LVIO information-weight tier, the async tick.

On these events both packages' windows leave ground truth after the
ignition, the reference's as the port's: each lidar registration stays
within millimetres of ground truth, but the inertial odometry's seed for
the next scan falls further behind the registered chain at every scan.
The test holds the port to the reference there: the same ignition stamp,
the same registrations (stamps, and each relative pose within 2e-3 m /
2e-3 rad, PERF.md §2's registration agreement), seeds at the same stamps,
and within 10% of each other the worst seed error and the two packages'
errors against ground truth: the ATE of each tick's newest state and the
newest state's error. Seed by seed the packages differ by up to 0.13 m at
the first two scans after the ignition and by under 0.02 m after them
(8.5 s of events). It prints both packages' readings.

One package alone, at any duration (the readings only)::

    JAX_PLATFORMS=cpu python tests/test_torch_lvio_vendored.py jax 12
"""

import dataclasses
import gzip
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SCAN_GZ = ROOT / "tests" / "data" / "test_scan_vlp16.pcd.gz"
N_RINGS, WIDTH = 16, 1800
SEED, IMU_HZ, CAM_HZ, LIDAR_HZ = 11, 200.0, 20.0, 10.0
DURATION = 8.5
POS_TOL, ROT_TOL = 2e-3, 2e-3       # PERF.md §2, one registration
RTOL = 0.1                          # the worst seed error, the ATEs


def _events(duration):
    """The reference's events with the vendored scan seen from each scan's
    lidar pose (numpy), and the lidar's ground-truth poses by stamp."""
    import jax.numpy as jnp
    from beam_slam_tpu.core import lie
    from beam_slam_tpu.lidar.pcd import load_pcd
    from beam_slam_tpu.pipeline import sim_session as jss
    traj, events, _ = jss.generate_session_events(
        mode="LVIO", duration_s=duration, imu_hz=IMU_HZ, cam_hz=CAM_HZ,
        lidar_hz=LIDAR_HZ, seed=SEED)
    with tempfile.TemporaryDirectory() as d:
        raw = Path(d) / "scan.pcd"
        raw.write_bytes(gzip.decompress(SCAN_GZ.read_bytes()))
        cloud = load_pcd(str(raw))
    stamps = [ev[1] for ev in events if ev[0] == "scan"]
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    lidar_gt, points = {}, {}
    for i, t in enumerate(stamps):
        q_wl = np.asarray(lie.quat_mul(gt.q[i], jnp.asarray(jss.Q_BL)))
        p_wl = np.asarray(gt.p[i] + lie.quat_rotate(gt.q[i],
                                                    jnp.asarray(jss.P_BL)))
        lidar_gt[t] = (q_wl, p_wl)
        points[t] = np.asarray(lie.quat_rotate(
            lie.quat_conj(jnp.asarray(q_wl))[None], cloud.xyz - p_wl))
    return traj, events, cloud, lidar_gt, points


def _lie():
    from beam_slam_tpu_torch.core import lie_np
    return lie_np


def _rel(q_a, p_a, q_b, p_b):
    lie = _lie()
    q_a, p_a, q_b, p_b = (np.asarray(x, np.float32)
                          for x in (q_a, p_a, q_b, p_b))
    qi = lie.quat_conj(q_a)
    return lie.quat_mul(qi, q_b), lie.quat_rotate(qi, p_b - p_a)


def _rot(dq) -> float:
    return float(np.linalg.norm(_lie().so3_log(np.asarray(dq, np.float32))))


def run(package, duration=DURATION, log=print):
    """One package's mapper on the vendored events. Returns its readings:
    the ignition stamp, every lidar factor by stamps, every seed's error
    against the previous registered pose (ground truth's relative pose
    taken out) by stamp, the newest state of each tick, and the ATEs."""
    traj, events, cloud, lidar_gt, points = _events(duration)
    rig = {}
    if package == "jax":
        from beam_slam_tpu.lidar.cloud import organize_scan
        from beam_slam_tpu.pipeline import sim_session as rig_mod
        from beam_slam_tpu.pipeline.config import LocalMapperConfig
        from beam_slam_tpu.pipeline.local_mapper import LocalMapper
        feed = list(events)
        grids = {t: organize_scan(points[t], cloud.ring, cloud.time,
                                  N_RINGS, WIDTH) for t in points}
        make = lambda cfg: LocalMapper(cfg)   # noqa: E731
        rig["cam"] = rig_mod.CAM
    else:
        from beam_slam_tpu_torch import bridge
        from beam_slam_tpu_torch.lidar.cloud import organize_scan
        from beam_slam_tpu_torch.pipeline import sim_session as rig_mod
        from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
        from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
        feed = [ev if ev[0] == "scan" else bridge.session_events_from_numpy(
            [("cam", ev[1]._asdict()) if ev[0] == "cam" else ev], "cpu")[0]
            for ev in events]
        grids = {t: organize_scan(points[t], cloud.ring, cloud.time,
                                  N_RINGS, WIDTH, device="cpu")
                 for t in points}
        make = lambda cfg: LocalMapper(cfg, device="cpu")   # noqa: E731
        rig["cam"] = rig_mod.CAM
    cfg = LocalMapperConfig.from_yaml(str(ROOT / "configs" / "lvio.yaml"))
    cfg.calibration = dataclasses.replace(
        cfg.calibration, q_baselink_lidar=rig_mod.Q_BL,
        p_baselink_lidar=rig_mod.P_BL, camera=rig["cam"],
        q_baselink_cam=rig_mod.Q_BC, p_baselink_cam=rig_mod.P_BC,
        camera_hz=CAM_HZ)
    mapper = make(cfg)
    reg, sm = mapper.lo.registration, mapper.smoother
    out = dict(factors={}, seed_err={}, newest={})
    register = reg.register_new_scan

    def registered(stamp, features, q_seed, p_seed, txn, grid=None):
        prev = reg.prev
        n0 = len(txn.rel_poses)
        ok = register(stamp, features, q_seed, p_seed, txn, grid=grid)
        if prev is not None and prev[0] in lidar_gt:
            q_s = _lie().quat_mul(np.asarray(q_seed, np.float32),
                                  np.asarray(rig_mod.Q_BL, np.float32))
            p_s = np.asarray(p_seed, np.float32) + _lie().quat_rotate(
                np.asarray(q_seed, np.float32),
                np.asarray(rig_mod.P_BL, np.float32))
            _, dp_s = _rel(prev[1], prev[2], q_s, p_s)
            _, dp_gt = _rel(*lidar_gt[prev[0]], *lidar_gt[stamp])
            out["seed_err"][stamp] = float(np.linalg.norm(dp_s - dp_gt))
        for f in txn.rel_poses[n0:]:
            dq_gt, dp_gt = _rel(*lidar_gt[f.stamp_i], *lidar_gt[f.stamp_j])
            out["factors"][(f.stamp_i, f.stamp_j)] = (
                np.asarray(f.dq), np.asarray(f.dp))
            log(f"[{package}] factor {f.stamp_i}->{f.stamp_j}: "
                f"{np.linalg.norm(f.dp - dp_gt):.4f} m / "
                f"{_rot(_lie().quat_mul(_lie().quat_conj(dq_gt), f.dq)):.4f}"
                f" rad off ground truth; seed of {stamp} "
                f"{out['seed_err'].get(stamp, float('nan')):.4f} m off; the "
                f"smoother's last solved stamp {sm.last_solved_stamp}, the "
                f"inertial odometry's anchor {mapper.io.model.t_kf}",
                flush=True)
        return ok
    reg.register_new_scan = registered

    t0 = time.perf_counter()
    for ev in feed:
        kind = ev[0]
        if kind == "imu":
            mapper.on_imu(ev[1], ev[2], ev[3])
        elif kind == "pose":
            mapper.on_pose(ev[1], ev[2], ev[3])
        elif kind == "scan":
            mapper.on_scan(ev[1], grids[ev[1]])
        elif kind == "cam":
            mapper.on_camera_measurement(ev[1])
        else:
            mapper.tick()
            if mapper.initialized and sm.current_stamps():
                t = sm.current_stamps()[-1]
                out["newest"][t] = np.asarray(sm.get_state(t)["p"],
                                              np.float64).copy()
    mapper.flush()
    from beam_slam_tpu_torch.utils.evaluation import ate_rmse
    ts = sorted(out["newest"])
    gt = np.asarray(traj.sample(np.asarray(ts, np.float32)).p, np.float64)
    est = np.stack([out["newest"][t] for t in ts])
    out.update(
        ignition=mapper.init.result["stamp"],
        ate=ate_rmse(est, gt),
        # the newest state's error after the rigid fit of the whole track
        last_err=float(np.linalg.norm(_fit(est, gt)[-1] - gt[-1])),
        wall=time.perf_counter() - t0)
    log(f"[{package}] {duration} s of events: ignition at "
        f"{out['ignition']} s; {len(out['factors'])} lidar factors, worst "
        f"seed error {max(out['seed_err'].values()):.4f} m; each tick's "
        f"newest state: ATE {out['ate']:.4f} m over {len(ts)} ticks, the "
        f"last ({ts[-1]} s) {out['last_err']:.4f} m off ground truth; "
        f"wall {out['wall']:.0f} s", flush=True)
    return out


def _fit(est, gt):
    """est after the rigid (SE(3)) fit to gt."""
    from beam_slam_tpu_torch.utils.evaluation import align_umeyama
    R, t, _ = align_umeyama(est, gt, with_scale=False)
    return est @ R.T + t


@pytest.mark.slow
def test_lvio_vendored_session_follows_reference():
    j = run("jax")
    p = run("port")
    assert p["ignition"] == j["ignition"]
    assert sorted(p["factors"]) == sorted(j["factors"])
    for stamps, (dq, dp) in p["factors"].items():
        dq_j, dp_j = j["factors"][stamps]
        assert float(np.linalg.norm(dp - dp_j)) < POS_TOL, stamps
        assert _rot(_lie().quat_mul(_lie().quat_conj(dq_j), dq)) < ROT_TOL
    assert sorted(p["seed_err"]) == sorted(j["seed_err"])
    worst = [max(x["seed_err"].values()) for x in (p, j)]
    assert abs(worst[0] - worst[1]) <= RTOL * worst[1]
    for key in ("ate", "last_err"):
        assert abs(p[key] - j[key]) <= RTOL * j[key], key


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    run(sys.argv[1], float(sys.argv[2]))
