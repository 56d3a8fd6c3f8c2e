"""Parity of the port's LIO LocalMapper (beam_slam_tpu_torch.pipeline) with
the JAX reference: the sync oracle session here, the async tick's session
in tests/test_torch_local_mapper_async.py, and the small LocalMapper,
SLAMInitialization and sim-session cases (the VIO and LVIO mappers'
construction and the camera and pose streams among them).

The session: the reference's ``generate_session_events`` in LIO mode
(analytic trajectory, the sim's 16 × 504 structured scene, 200 Hz IMU), the
events converted by the bridge and fed to both mappers. Reduced size, to
stay inside the CPU test budget (a JAX registration on the CPU is ~2.3 s):
3 s of events with the lidar at 5 Hz, 16 states and a 2 s lag, LM capped at
8 steps, ignition after 1.0 m of registered path (at 1.4 s). Per tick: the same
initialization, window stamps, counters, queue and factor counts, window
states within 2e-3 m / 2e-3 rad (the registration-agreement bound of
PERF.md §2: every scan's factor comes from a float32 registration in
another order); the ignition at the same stamp and its state within
1e-3 m / 1e-3 rad; the newest-state ATE of both sessions under 0.05 m.

The reference's sessions (sync here, async in the async file) cost ~2 min of
CPU compile and run each, so their results (and the FRAMEINIT ignition's) are
recorded in tests/data/local_mapper_lio_jax.json.gz
(tests/test_torch_jax_recording.py) and the port is held to the recording; the
slow test_recording_is_the_jax_packages_session runs the reference again and
holds it to the recording, and ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_local_mapper.py record`` rewrites it.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.models import slam_initialization as jsi
from beam_slam_tpu.models.inertial_odometry import ImuParams as JImuParams
from beam_slam_tpu.pipeline import config as jcfg
from beam_slam_tpu.pipeline import local_mapper as jlm
from beam_slam_tpu.pipeline import sim_session as jss
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.lidar import scan_registration as tsr
from beam_slam_tpu_torch.models import lidar_odometry as tlo
from beam_slam_tpu_torch.models import slam_initialization as tsi
from beam_slam_tpu_torch.models import visual_odometry as tvo
from beam_slam_tpu_torch.models.inertial_odometry import \
    ImuParams as TImuParams
from beam_slam_tpu_torch.pipeline import config as tcfg
from beam_slam_tpu_torch.pipeline import local_mapper as tlm
from beam_slam_tpu_torch.pipeline import sim_session as tss
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from beam_slam_tpu_torch.utils.evaluation import ate_rmse

import test_torch_jax_recording as jax_recording

torch.set_num_threads(2)

DURATION, LIDAR_HZ, SEED = 3.0, 5.0, 11
MAPPER = dict(mode="LIO", lag_duration=2.0, max_states=16, max_iterations=8)
INIT = dict(mode="LIDAR", min_trajectory_length_m=1.0, min_observability=0.1)
POS_TOL, ROT_TOL = 2e-3, 2e-3          # window states, every tick
IGN_POS_TOL, IGN_ROT_TOL = 1e-3, 1e-3  # the ignition state
ATE_BOUND = 0.05
ARENAS = bridge.ARENAS
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(cfg_mod, init_mod, async_solve: bool):
    """The session's configuration: the sync oracle (no async tick, the sync
    scan-to-map strategy) or the default async mode (the async tick, the
    pipelined strategy)."""
    return cfg_mod.LocalMapperConfig(
        **MAPPER, async_solve=async_solve,
        pipelined_registration=async_solve,
        init=init_mod.InitParams(**INIT),
        calibration=cfg_mod.CalibrationConfig(
            q_baselink_lidar=jss.Q_BL, p_baselink_lidar=jss.P_BL))


def _record(mapper, t):
    sm = mapper.smoother
    stamps = sm.current_stamps()
    states = {s: sm.get_state(s) for s in stamps}
    return dict(t=t, initialized=mapper.initialized, stamps=stamps,
                counters=dict(sm.counters), pending=len(sm._pending),
                factors={n: int(getattr(sm, n).active.sum())
                         for n in ARENAS},
                p={s: np.asarray(x["p"]) for s, x in states.items()},
                q={s: np.asarray(x["q"]) for s, x in states.items()})


def _drive(mapper, events):
    """Feed the events; a record after every tick and after the flush."""
    recs = []
    for ev in events:
        if ev[0] == "imu":
            mapper.on_imu(ev[1], ev[2], ev[3])
        elif ev[0] == "scan":
            mapper.on_scan(ev[1], ev[2])
        else:
            mapper.tick()
            recs.append(_record(mapper, ev[1]))
    mapper.flush()
    recs.append(_record(mapper, "flush"))
    return recs


def _rot_err(q_a, q_b) -> float:
    dq = lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float64)),
                         np.asarray(q_b, np.float64))
    return float(np.linalg.norm(lie_np.so3_log(dq)))


def _ate(recs, traj):
    """The newest window state after every tick against ground truth (the
    reference's session scoring), se3-aligned."""
    est = {}
    for r in recs[:-1]:
        if r["initialized"] and r["stamps"]:
            est[r["stamps"][-1]] = r["p"][r["stamps"][-1]]
    stamps = sorted(est)
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    return ate_rmse(np.stack([est[s] for s in stamps]), np.asarray(gt.p))


RECORDING = "local_mapper_lio_jax"


def _events():
    return jss.generate_session_events(
        mode="LIO", duration_s=DURATION, lidar_hz=LIDAR_HZ, seed=SEED)


def jax_session(async_solve: bool, events=None):
    """The reference's mapper over the session's events: its record after
    every tick and what the tests read of it at the end."""
    events = _events()[1] if events is None else events
    mj = jlm.LocalMapper(_config(jcfg, jsi, async_solve))
    recs = _drive(mj, events)
    return dict(
        recs=recs, init=dict(mj.init.result), trajectory=mj.trajectory(),
        pose={t: mj.current_pose(t) for t in (None, DURATION + 0.05)},
        solve_count=mj.smoother.solve_count)


def _mode(async_solve: bool) -> str:
    return "async" if async_solve else "sync"


def run_sessions(async_solve: bool):
    """The reference's events through the port's mapper, beside the
    reference's recorded session."""
    traj, events, _ = _events()
    flat = [("scan", ev[1], {k: np.asarray(getattr(ev[2], k))
                             for k in ("xyz", "time", "valid")})
            if ev[0] == "scan" else ev for ev in events]
    port_events = bridge.session_events_from_numpy(flat, "cpu")
    mj = jax_recording.load(RECORDING)[_mode(async_solve)]
    mt = tlm.LocalMapper(_config(tcfg, tsi, async_solve), device="cpu")
    recs_t = _drive(mt, port_events)
    return dict(traj=traj, mj=mj, mt=mt, recs_j=mj["recs"], recs_t=recs_t)


def assert_sessions_agree(s):
    recs_j, recs_t = s["recs_j"], s["recs_t"]
    assert len(recs_j) == len(recs_t)
    for a, b in zip(recs_j, recs_t):
        label = f"tick {a['t']}"
        for k in ("initialized", "stamps", "counters", "pending", "factors"):
            assert a[k] == b[k], (label, k, a[k], b[k])
        for t in a["stamps"]:
            dp = float(np.linalg.norm(a["p"][t] - b["p"][t]))
            assert dp < POS_TOL, (label, t, dp)
            assert _rot_err(a["q"][t], b["q"][t]) < ROT_TOL, (label, t)
    rj, rt = s["mj"]["init"], s["mt"].init.result
    assert rj["stamp"] == rt["stamp"]
    assert float(np.linalg.norm(rj["p"] - rt["p"])) < IGN_POS_TOL
    assert _rot_err(rj["q"], rt["q"]) < IGN_ROT_TOL
    # the session ignited early and tracked to its end, on both sides
    assert recs_t[-1]["initialized"] and rt["stamp"] < DURATION / 2
    assert len(recs_t[-1]["stamps"]) >= 8
    for recs in (recs_j, recs_t):
        assert _ate(recs, s["traj"]) < ATE_BOUND


@pytest.fixture(scope="module")
def sync_session():
    return run_sessions(async_solve=False)


def test_sync_session_matches_reference(sync_session):
    assert_sessions_agree(sync_session)
    mj, mt = sync_session["mj"], sync_session["mt"]
    sm = mt.smoother
    assert sm.solve_count >= 8 and sm._last_marginalized_stamps
    # the publisher surfaces: the trajectory, the newest and a predicted pose
    tj, tt = mj["trajectory"], mt.trajectory()
    assert [t for t, *_ in tt] == [t for t, *_ in tj]
    for (_, _, pj), (_, _, pt) in zip(tj, tt):
        assert float(np.linalg.norm(pt - pj)) < POS_TOL
    for t in (None, DURATION + 0.05):
        (qj, pj), (qt, pt) = mj["pose"][t], mt.current_pose(t)
        assert float(np.linalg.norm(pt - np.asarray(pj))) < POS_TOL, t
        assert _rot_err(qj, qt) < ROT_TOL, t
    mt.reset()   # the reset protocol: back to initialization
    assert not mt.initialized and not mt.smoother.current_stamps()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["sync", "async", "frameinit"])
def test_recording_is_the_jax_packages_session(case):
    """The reference's sessions run again equal their recording."""
    live = (jax_frameinit() if case == "frameinit"
            else jax_session(case == "async"))
    jax_recording.assert_same(jax_recording.encode_roundtrip(live),
                              jax_recording.load(RECORDING)[case])


def _frameinit_data():
    import test_initialization as ti
    return ti.make_rotated_world_data(
        bg_true=FRAMEINIT_BG, rot=np.array([0.2, 0.25, -0.1]), T=4.0)


FRAMEINIT_BG = np.array([0.01, -0.015, 0.02])


def jax_frameinit():
    """The reference's FRAMEINIT initializer over the rotated-world path:
    what add_pose returned at each pose, the ignition result, and the
    smoother's window after it. Its smoother is the session's (a 10 s
    lag)."""
    kf_t, q_path, p_path, _, t_imu, w, a = _frameinit_data()
    smj = jsm.FixedLagSmoother(dataclasses.replace(
        _config(jcfg, jsi, False).smoother_config(), lag_duration=10.0))
    done = {}
    ij = jsi.SLAMInitialization(
        smj, jsi.InitParams(mode="FRAMEINIT", min_trajectory_length_m=2.0),
        JImuParams(), on_initialized=lambda r: done.update(jax=r))
    for i in range(len(t_imu)):
        ij.add_imu(t_imu[i], w[i], a[i])
    flags = [ij.add_pose(float(kf_t[i]), q_path[i], p_path[i])
             for i in range(len(kf_t))]
    return dict(flags=flags, result=dict(done["jax"]),
                stamps=smj.current_stamps(),
                active={n: getattr(smj, n).active.copy() for n in ARENAS},
                states={t: dict(smj.get_state(t))
                        for t in smj.current_stamps()})


def test_frameinit_ignition_matches_reference():
    """FRAMEINIT mode (tests/test_initialization.py:92): a rotated-world
    path with gyro bias and an IMU stream ignite both initializers at the
    same stamp; the aligned ignition graph solves to the same states. The
    reference's side is recorded with the sessions."""
    kf_t, q_path, p_path, _, t_imu, w, a = _frameinit_data()
    ref = jax_recording.load(RECORDING)["frameinit"]
    smt = tsm.FixedLagSmoother(dataclasses.replace(
        _config(tcfg, tsi, False).smoother_config(), lag_duration=10.0),
        device="cpu")
    done = {}
    it = tsi.SLAMInitialization(
        smt, tsi.InitParams(mode="FRAMEINIT", min_trajectory_length_m=2.0),
        TImuParams(), lidar_path=tsi.LidarPathInit(device="cpu"),
        on_initialized=lambda r: done.update(port=r), device="cpu")
    for i in range(len(t_imu)):
        it.add_imu(t_imu[i], w[i], a[i])
    for i in range(len(kf_t)):
        ft = it.add_pose(float(kf_t[i]), q_path[i], p_path[i])
        assert ref["flags"][i] == ft, i
    res = ref["result"]
    assert it.initialized and done["port"]["stamp"] == res["stamp"]
    np.testing.assert_allclose(done["port"]["bg"], res["bg"], atol=1e-5)
    np.testing.assert_allclose(done["port"]["bg"], FRAMEINIT_BG, atol=3e-3)
    np.testing.assert_allclose(done["port"]["q_align"], res["q_align"],
                               atol=1e-5)
    assert smt.current_stamps() == ref["stamps"]
    assert len(smt.current_stamps()) >= 4
    for n in ARENAS:
        np.testing.assert_array_equal(getattr(smt, n).active,
                                      ref["active"][n], err_msg=n)
    for t in smt.current_stamps():
        st, sj = smt.get_state(t), ref["states"][t]
        assert float(np.linalg.norm(st["p"] - sj["p"])) < IGN_POS_TOL, t
        assert _rot_err(st["q"], sj["q"]) < IGN_ROT_TOL, t


@pytest.mark.parametrize("mode", ["VIO", "LVIO"])
def test_vision_mapper_builds_like_reference(mode):
    """LocalMapper of configs/{vio,lvio}.yaml with the calibration tier: the
    reference's extrinsics (the camera's, and the lidar's in LVIO), arena
    capacities, initialization mode, registration strategy and tracker."""
    mappers = []
    for cfg_mod, lm_mod, dev in ((jcfg, jlm, {}), (tcfg, tlm,
                                                   {"device": "cpu"})):
        cfg = cfg_mod.LocalMapperConfig.from_yaml(
            str(CONFIGS / f"{mode.lower()}.yaml"))
        cfg.calibration = cfg_mod.CalibrationConfig.from_yaml(
            str(CONFIGS / "calibration_params.yaml"),
            str(CONFIGS / "calibrations"))
        mappers.append(lm_mod.LocalMapper(cfg, **dev))
    mj, mt = mappers
    smj, smt = mj.smoother, mt.smoother
    assert smt.ext_slot_of_name == smj.ext_slot_of_name
    assert ("cam0" in smt.ext_slot_of_name
            and ("lidar" in smt.ext_slot_of_name) == (mode == "LVIO"))
    np.testing.assert_allclose(smt.ext_q, np.asarray(smj.ext_q), atol=1e-7)
    np.testing.assert_allclose(smt.ext_p, np.asarray(smj.ext_p), atol=1e-7)
    for n in ARENAS:
        assert getattr(smt, n).capacity == getattr(smj, n).capacity, n
    assert (smt.cfg.max_landmarks, smt.cfg.max_reprojection_factors) == \
        (smj.cfg.max_landmarks, smj.cfg.max_reprojection_factors)
    assert mt.init.params.mode == mj.init.params.mode
    assert (mt.lo is None) == (mj.lo is None) == (mode == "VIO")
    if mt.lo is not None:
        assert type(mt.lo.registration).__name__ == \
            type(mj.lo.registration).__name__ == \
            "PipelinedScanToMapRegistration"
    assert tuple(mt.tracker.fast_cfg) == tuple(mj.tracker.fast_cfg)
    assert tuple(mt.tracker.lk_cfg) == tuple(mj.tracker.lk_cfg)
    assert mt.vo.params == tvo.VOParams(**dataclasses.asdict(mj.vo.params))


@pytest.mark.parametrize("mode", ["VIO", "LVIO"])
def test_vision_session_events_match_reference(mode):
    """The camera and pose streams of generate_session_events: the same
    events in the same order, the same ids, pixels within 1e-3 px (a few
    float32 rounding steps of a pixel, from the trajectory's float32 poses
    sampled by each package), poses within 1e-6."""
    _, ev_j, n_j = jss.generate_session_events(mode=mode, duration_s=0.6,
                                               lidar_hz=LIDAR_HZ)
    _, ev_t, n_t = tss.generate_session_events(mode=mode, duration_s=0.6,
                                               lidar_hz=LIDAR_HZ,
                                               device="cpu")
    assert n_j == n_t
    assert [e[0] for e in ev_j] == [e[0] for e in ev_t]
    kinds = {e[0] for e in ev_t}
    assert "cam" in kinds and ("pose" in kinds) == (mode == "VIO")
    for a, b in zip(ev_j, ev_t):
        if a[0] == "cam":
            a, b = a[1], b[1]
            assert a.stamp == b.stamp and len(a.ids) >= 20
            np.testing.assert_array_equal(b.ids, a.ids)
            np.testing.assert_allclose(b.pixels, a.pixels, atol=1e-3)
        elif a[0] == "pose":
            assert a[1] == b[1]
            np.testing.assert_allclose(b[2], a[2], atol=1e-6)
            np.testing.assert_allclose(b[3], a[3], atol=1e-6)


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    """device=None is the card: without one every entry point raises, none
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sm = tsm.FixedLagSmoother(tsm.SmootherConfig(), device="cpu")
    reg, _ = tcfg.LocalMapperConfig(mode="LIO").build_scan_registration(
        device="cpu")
    calls = (
        lambda: tlm.LocalMapper(tcfg.LocalMapperConfig(mode="LIO")),
        lambda: tss.run_synthetic_session(mode="LIO", duration_s=1.0),
        lambda: tss.generate_session_events(mode="LIO", duration_s=1.0),
        lambda: tlo.LidarOdometry(sm, reg),
        lambda: tsi.SLAMInitialization(sm),
        lambda: tsi.LidarPathInit(),
        lambda: tsr.ScanToMapLoamRegistration(),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_session_events_match_reference():
    """The port's generate_session_events gives the reference's stream:
    the same stamps and order, IMU samples within float32 rounding of the
    trajectory's derivatives, and each scan's grid within 1e-4 m."""
    _, ev_j, n_j = jss.generate_session_events(mode="LIO", duration_s=1.0,
                                               lidar_hz=LIDAR_HZ)
    _, ev_t, n_t = tss.generate_session_events(mode="LIO", duration_s=1.0,
                                               lidar_hz=LIDAR_HZ,
                                               device="cpu")
    assert n_j == n_t and [e[:2] for e in ev_j] == [e[:2] for e in ev_t]
    for a, b in zip(ev_j, ev_t):
        if a[0] == "imu":
            np.testing.assert_allclose(b[2], np.asarray(a[2]), atol=1e-5)
            np.testing.assert_allclose(b[3], np.asarray(a[3]), atol=1e-4)
        elif a[0] == "scan":
            np.testing.assert_array_equal(b[2].valid.numpy(),
                                          np.asarray(a[2].valid))
            np.testing.assert_allclose(b[2].xyz.numpy(),
                                       np.asarray(a[2].xyz), atol=1e-4)


def test_smoother_config_matches_reference_for_lio():
    """LocalMapper builds its smoother from the config: field by field the
    reference's (the configs' own check is tests/test_torch_config.py)."""
    cj = _config(jcfg, jsi, True).smoother_config()
    ct = _config(tcfg, tsi, True).smoother_config()
    for f in dataclasses.fields(cj):
        if f.name != "solver":
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    for name in tgn.SolverOptions._fields:
        assert getattr(ct.solver, name) == getattr(cj.solver, name), name


if __name__ == "__main__" and sys.argv[1:] == ["record"]:
    events = _events()[1]
    print(jax_recording.save(RECORDING, dict(
        **{_mode(a): jax_session(a, events) for a in (False, True)},
        frameinit=jax_frameinit())))
