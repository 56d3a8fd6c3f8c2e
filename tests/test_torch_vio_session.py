"""Parity of the port's VIO LocalMapper (beam_slam_tpu_torch.pipeline) with
the JAX reference: a VIO session on the reference's events, and the
VISUAL ignition through LocalMapper.

The session: the reference's ``generate_session_events`` in VIO mode (its
analytic trajectory, 200 Hz IMU, a seeded landmark corridor seen at 10 Hz
through the sim's camera with 0.3 px of noise, a noisy pose stream), the
events converted by the bridge and fed to both mappers. Reduced size, to
stay inside the CPU test budget: 3 s of events, 16 states and a 2 s lag,
256 landmarks and 1024 reprojection factors, LM up to 8 steps, the default
async tick; the ignition from the pose stream (FRAMEINIT, as the sim
ignites VIO) after 1.0 m. Per tick: the same initialization, window
stamps, counters, queue, factor and landmark counts and keyframes, window
states within 2e-3 m / 2e-3 rad; the ignition at the same stamp; the
newest-state ATE of both sessions under the reference envelope test's
0.05 m (tests/test_envelope_e2e.py).

The reference's session is recorded in tests/data/vio_session_jax.json.gz
(tests/test_torch_jax_recording.py: ~1.5 min of CPU compile and run a session);
the slow test_recording_is_the_jax_packages_session runs it again and holds it
to the recording, and ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_vio_session.py record`` rewrites it.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.models import slam_initialization as jsi
from beam_slam_tpu.pipeline import config as jcfg
from beam_slam_tpu.pipeline import local_mapper as jlm
from beam_slam_tpu.pipeline import sim_session as jss
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.models import slam_initialization as tsi
from beam_slam_tpu_torch.pipeline import config as tcfg
from beam_slam_tpu_torch.pipeline import local_mapper as tlm
from beam_slam_tpu_torch.utils.evaluation import ate_rmse

import test_torch_jax_recording as jax_recording

torch.set_num_threads(2)

SEED, IMU_HZ, CAM_HZ, LIDAR_HZ = 11, 200.0, 10.0, 5.0
VIO_DURATION = 3.0
# 256 landmarks, as lvio.yaml: with 64 the reference's store overflows on a
# keyframe that observes more landmarks than it holds (it evicts only
# landmarks the keyframe does not observe)
CAPACITIES = dict(max_states=16, max_landmarks=256,
                  max_reprojection_factors=1024, max_iterations=8)
POS_TOL, ROT_TOL = 2e-3, 2e-3          # window states, every tick
ATE_BOUND = 0.05                       # tests/test_envelope_e2e.py
ARENAS = bridge.ARENAS


def config(cfg_mod, init_mod, mode, init, async_solve, lag=2.0):
    """The session's configuration on either side: the sim's rig
    (sim_session's camera and extrinsics), the mode's information-weight
    tier."""
    use_cam = mode in ("VIO", "LVIO")
    return cfg_mod.LocalMapperConfig(
        mode=mode, lag_duration=lag, **CAPACITIES, async_solve=async_solve,
        pipelined_registration=False, init=init_mod.InitParams(**init),
        calibration=cfg_mod.CalibrationConfig(
            camera=_cam(cfg_mod) if use_cam else None,
            q_baselink_cam=jss.Q_BC if use_cam else None,
            p_baselink_cam=jss.P_BC if use_cam else None,
            q_baselink_lidar=jss.Q_BL, p_baselink_lidar=jss.P_BL,
            imu_hz=IMU_HZ, camera_hz=CAM_HZ, lidar_hz=LIDAR_HZ))


def _cam(cfg_mod):
    if cfg_mod is jcfg:
        return jss.CAM
    from beam_slam_tpu_torch.vision.camera import PinholeRadtan
    return PinholeRadtan(*jss.CAM[:4])


def record(mapper, t):
    sm = mapper.smoother
    stamps = sm.current_stamps()
    states = {s: sm.get_state(s) for s in stamps}
    return dict(t=t, initialized=mapper.initialized, stamps=stamps,
                counters=dict(sm.counters), pending=len(sm._pending),
                factors={n: int(getattr(sm, n).active.sum())
                         for n in ARENAS},
                landmarks=sorted(sm.slot_of_lm_id),
                keyframes=list(mapper.vo.keyframes) if mapper.vo else [],
                p={s: np.asarray(x["p"]) for s, x in states.items()},
                q={s: np.asarray(x["q"]) for s, x in states.items()})


def drive(mapper, events):
    """Feed the events; a record after every tick and after the flush."""
    recs = []
    for ev in events:
        kind = ev[0]
        if kind == "imu":
            mapper.on_imu(ev[1], ev[2], ev[3])
        elif kind == "scan":
            mapper.on_scan(ev[1], ev[2])
        elif kind == "pose":
            mapper.on_pose(ev[1], ev[2], ev[3])
        elif kind == "cam":
            mapper.on_camera_measurement(ev[1])
        else:
            mapper.tick()
            recs.append(record(mapper, ev[1]))
    mapper.flush()
    recs.append(record(mapper, "flush"))
    return recs


def rot_err(q_a, q_b) -> float:
    dq = lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float64)),
                         np.asarray(q_b, np.float64))
    return float(np.linalg.norm(lie_np.so3_log(dq)))


def newest_ate(recs, traj):
    est = {}
    for r in recs[:-1]:
        if r["initialized"] and r["stamps"]:
            est[r["stamps"][-1]] = r["p"][r["stamps"][-1]]
    stamps = sorted(est)
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    return ate_rmse(np.stack([est[s] for s in stamps]), np.asarray(gt.p))


def port_events(events):
    """The reference's events as numpy, through the bridge."""
    flat = []
    for ev in events:
        if ev[0] == "scan":
            flat.append(("scan", ev[1], {k: np.asarray(getattr(ev[2], k))
                                         for k in ("xyz", "time", "valid")}))
        elif ev[0] == "cam":
            flat.append(("cam", ev[1]._asdict()))
        else:
            flat.append(ev)
    return bridge.session_events_from_numpy(flat, "cpu")


def _record_lidar_factors(registration, side, pairs, replace=False):
    """Record each relative-pose factor the lidar odometry's registration
    emits in ``pairs[(stamp_i, stamp_j)][side]``; with ``replace`` the
    transaction carries the reference's factor of the same stamps instead
    (its measurement and weight), so both smoothers see the same factors."""
    register = registration.register_new_scan

    def registered(stamp, features, q_seed, p_seed, txn, grid=None):
        n0 = len(txn.rel_poses)
        ok = register(stamp, features, q_seed, p_seed, txn, grid=grid)
        for i in range(n0, len(txn.rel_poses)):
            f = txn.rel_poses[i]
            pair = pairs.setdefault((f.stamp_i, f.stamp_j), {})
            pair[side] = f
            if replace:
                ref = pair["jax"]
                txn.rel_poses[i] = dataclasses.replace(
                    f, dq=ref.dq, dp=ref.dp, sqrt_info=ref.sqrt_info)
        return ok
    registration.register_new_scan = registered


def session_events(mode, duration):
    return jss.generate_session_events(
        mode=mode, duration_s=duration, imu_hz=IMU_HZ, cam_hz=CAM_HZ,
        lidar_hz=LIDAR_HZ, seed=SEED)


def jax_session(mode, duration, init, async_solve, shared_lidar=False):
    """The reference's mapper on its events: its record after every tick,
    its ignition and, with ``shared_lidar``, its lidar odometry factors by
    stamps."""
    pairs = {}
    mj = jlm.LocalMapper(config(jcfg, jsi, mode, init, async_solve))
    if shared_lidar:
        _record_lidar_factors(mj.lo.registration, "jax", pairs)
    recs = drive(mj, session_events(mode, duration)[1])
    return dict(recs=recs, init=dict(mj.init.result),
                lidar={k: {f: np.asarray(getattr(v["jax"], f))
                           for f in ("dq", "dp", "sqrt_info")}
                       for k, v in pairs.items()})


def run_sessions(mode, duration, init, async_solve, shared_lidar=False,
                 recording=None):
    """The port's mapper on the reference's events, beside the reference's
    session (``recording``: its recording's name; else run here).
    ``shared_lidar``: the port's smoother gets the reference's lidar
    odometry factors in place of its own, which are kept for comparison
    (``lidar_pairs``)."""
    traj, events, _ = session_events(mode, duration)
    mj = (jax_recording.load(recording) if recording else
          jax_session(mode, duration, init, async_solve, shared_lidar))
    pairs = {k: {"jax": types.SimpleNamespace(**v)}
             for k, v in mj["lidar"].items()}
    mt = tlm.LocalMapper(config(tcfg, tsi, mode, init, async_solve),
                         device="cpu")
    if shared_lidar:
        _record_lidar_factors(mt.lo.registration, "port", pairs,
                              replace=True)
    recs_t = drive(mt, port_events(events))
    return dict(traj=traj, mj=mj, mt=mt, recs_j=mj["recs"], recs_t=recs_t,
                duration=duration, lidar_pairs=pairs)


def assert_sessions_agree(s, min_states):
    recs_j, recs_t = s["recs_j"], s["recs_t"]
    assert len(recs_j) == len(recs_t)
    for a, b in zip(recs_j, recs_t):
        label = f"tick {a['t']}"
        for k in ("initialized", "stamps", "counters", "pending", "factors",
                  "landmarks", "keyframes"):
            assert a[k] == b[k], (label, k, a[k], b[k])
        for t in a["stamps"]:
            dp = float(np.linalg.norm(a["p"][t] - b["p"][t]))
            assert dp < POS_TOL, (label, t, dp)
            assert rot_err(a["q"][t], b["q"][t]) < ROT_TOL, (label, t)
    rj, rt = s["mj"]["init"], s["mt"].init.result
    assert rj["stamp"] == rt["stamp"]
    assert recs_t[-1]["initialized"] and rt["stamp"] < s["duration"] / 2
    assert len(recs_t[-1]["stamps"]) >= min_states
    for recs in (recs_j, recs_t):
        assert newest_ate(recs, s["traj"]) < ATE_BOUND


VIO_SESSION = dict(mode="VIO", duration=VIO_DURATION,
                   init=dict(mode="LIDAR", min_trajectory_length_m=1.0,
                             min_observability=0.1), async_solve=True)
RECORDING = "vio_session_jax"


def test_vio_session_matches_reference():
    s = run_sessions(**VIO_SESSION, recording=RECORDING)
    assert s["mt"].init.params.mode == "FRAMEINIT" and s["mt"].lo is None
    assert_sessions_agree(s, min_states=4)   # a keyframe every ~0.5 s
    last = s["recs_t"][-1]
    keyframes = set().union(*(r["keyframes"] for r in s["recs_t"]))
    assert len(keyframes) >= 3 and len(last["landmarks"]) >= 20
    assert last["factors"]["arena_reproj"] >= 50
    assert s["mt"].smoother.solve_count >= 4   # the ignition, 3 keyframes


@pytest.mark.slow
def test_recording_is_the_jax_packages_session():
    """The reference's session run again equals its recording."""
    jax_recording.assert_same(
        jax_recording.encode_roundtrip(jax_session(**VIO_SESSION)),
        jax_recording.load(RECORDING))


@pytest.mark.slow
def test_visual_ignition_through_mapper_matches_reference():
    """tests/test_visual_init.py:65 through LocalMapper (VIO, VISUAL
    initialization): tracks and IMU ignite both mappers at the same stamp
    with the same scale, gravity alignment and ignition window; the port's
    SfM RANSAC takes the reference's samples. Slow (~30 s on the CPU, most
    of it the reference's compiles); tests/test_torch_vision.py holds the
    SfM path it runs, and chip_smoke.py phase 12c the ignition on the
    card."""
    import test_visual_init as tvi
    from beam_slam_tpu.utils import sim as jsim
    from test_torch_vision import ref_ransac_idx
    rng = np.random.default_rng(5)
    traj = jsim.AnalyticTrajectory(amp_p=(0.6, 0.6, 0.25),
                                   v_drift=(0.35, 0, 0))
    lms = np.stack([rng.uniform(4, 12, 120), rng.uniform(-5, 5, 120),
                    rng.uniform(-3, 3, 120)], axis=1).astype(np.float32)
    init = dict(mode="VISUAL", min_trajectory_length_m=0.8,
                keyframe_spacing_s=0.3, min_observability=0.1)
    mj = jlm.LocalMapper(config(jcfg, jsi, "VIO", init, False, lag=20.0))
    mt = tlm.LocalMapper(config(tcfg, tsi, "VIO", init, False, lag=20.0),
                         device="cpu")
    mt.init.ransac_idx = lambda n, m: ref_ransac_idx(n, m, 1)
    done = {}
    mj.init.on_initialized = lambda r, f=mj._on_initialized: (
        done.update(jax=r), f(r))
    mt.init.on_initialized = lambda r, f=mt._on_initialized: (
        done.update(port=r), f(r))
    tm = (np.arange(int(3.0 * IMU_HZ)) + 0.5) / IMU_HZ
    s = traj.sample(jnp.asarray(tm, jnp.float32))
    w, a = np.asarray(s.w_body), np.asarray(s.a_body)
    cam_i = 0
    for i in range(len(tm)):
        for m in (mj, mt):
            m.on_imu(float(tm[i]), w[i], a[i])
        t_cam = cam_i / CAM_HZ
        if tm[i] >= t_cam:
            g = traj.sample(jnp.asarray([t_cam], jnp.float32))
            ids, uvs = tvi.observe(g.q[0], g.p[0], lms)
            fj = mj.on_camera_measurement(
                tvi.CameraMeasurement(round(t_cam, 6), ids, uvs, uvs))
            ft = mt.on_camera_measurement(bridge.camera_measurement_from_numpy(
                dict(stamp=round(t_cam, 6), ids=ids, pixels=uvs,
                     pixels_undistorted=uvs)))
            assert fj == ft, t_cam
            cam_i += 1
            if fj:
                break
    assert mt.initialized and mj.initialized
    rj, rt = done["jax"], done["port"]
    assert rt["stamp"] == rj["stamp"]
    assert abs(rt["scale"] - rj["scale"]) < 1e-3 * abs(rj["scale"])
    assert abs(rt["scale"] - 1.0) > 1e-6
    np.testing.assert_allclose(rt["q_align"], rj["q_align"], atol=1e-3)
    stamps = mt.smoother.current_stamps()
    assert stamps == mj.smoother.current_stamps() and len(stamps) >= 4
    for t in stamps:
        st, sj = mt.smoother.get_state(t), mj.smoother.get_state(t)
        assert float(np.linalg.norm(st["p"] - sj["p"])) < POS_TOL, t
        assert rot_err(st["q"], sj["q"]) < ROT_TOL, t
    # the VO starts from the ignition (visual_odometry.cpp:653)
    assert mt.vo.initialized and mj.vo.initialized


if __name__ == "__main__" and sys.argv[1:] == ["record"]:
    print(jax_recording.save(RECORDING, jax_session(**VIO_SESSION)))
