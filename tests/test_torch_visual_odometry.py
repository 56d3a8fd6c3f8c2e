"""Parity of the port's VisualOdometry (beam_slam_tpu_torch.models) with the
JAX reference, on tests/test_vio_e2e.py's setup at a reduced size.

Both sides get the same measurements: the reference's analytic trajectory
and its 200 Hz IMU, a seeded field of 60 landmarks seen through the sim's
pinhole camera with 0.5 px of noise, 2 s at 10 Hz. Each drives a fixed-lag
smoother (32 states, a 1.5 s lag, so states and landmarks are
marginalized; LM up to 8 steps, the sync tick) with InertialOdometry and
VisualOdometry; the window is solved on every keyframe. One smoother shape
serves every case, the standalone mode's private graph included (32
states, 8 LM steps), so the reference's LM compiles once in this file.

Checked after every frame: the same keyframe decisions; the same
transactions — states at the same stamps within 1e-3 m / 1e-3 rad,
landmarks with the same ids at positions within 1e-3 m (inverse depths
within 1e-3 relative), reprojection factors with the same stamps, ids and
anchors, pixels and bearings within 1e-4 px; after each solve the same
window within 1e-3 m / 1e-3 rad.

The reference's two sessions (EUC and IDP landmarks: ~2 min of CPU compile and
run) are recorded in tests/data/visual_odometry_jax.json.gz
(tests/test_torch_jax_recording.py): its keyframe flags, transactions and
windows frame by frame; the slow test_recording_is_the_jax_packages_session
runs them again and holds them to the recording, and ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_visual_odometry.py record`` rewrites it.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beam_slam_tpu.models import inertial_odometry as jio
from beam_slam_tpu.models import visual_odometry as jvo
from beam_slam_tpu.models.visual_feature_tracker import \
    CameraMeasurement as JMeas
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu.utils import sim as jsim
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.models import inertial_odometry as tio
from beam_slam_tpu_torch.models import visual_odometry as tvo
from beam_slam_tpu_torch.models.visual_feature_tracker import \
    CameraMeasurement as TMeas
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from test_vio_e2e import CAM, P_BC, Q_BC, observe

import test_torch_jax_recording as jax_recording

torch.set_num_threads(2)

DURATION, CAM_HZ, IMU_HZ, N_LM, NOISE_PX = 2.0, 10.0, 200.0, 60, 0.5
SMOOTHER = dict(lag_duration=1.5, max_states=32, max_landmarks=64,
                max_reprojection_factors=1024, max_idp_factors=512)
VO = dict(keyframe_parallax_px=15.0, keyframe_max_dt=0.6)
POS_TOL, ROT_TOL = 1e-3, 1e-3
PIX_TOL = 1e-4
RECORDING = "visual_odometry_jax"


def _rot_err(q_a, q_b) -> float:
    dq = lie_np.quat_mul(lie_np.quat_conj(np.asarray(q_a, np.float64)),
                         np.asarray(q_b, np.float64))
    return float(np.linalg.norm(lie_np.so3_log(dq)))


def make_stream():
    """test_vio_e2e's trajectory and landmark field, measured by the
    reference's sim: [(t, imu [(t, w, a)], ids, pix)], the first at t=0,
    and the ignition state."""
    rng = np.random.default_rng(7)
    traj = jsim.AnalyticTrajectory(amp_p=(0.6, 0.6, 0.25),
                                   v_drift=(0.25, 0, 0),
                                   amp_r=(0.15, 0.12, 0.2))
    lms = np.stack([rng.uniform(4, 12, N_LM), rng.uniform(-5, 5, N_LM),
                    rng.uniform(-3, 3, N_LM)], axis=1).astype(np.float32)
    g0 = traj.sample(jnp.zeros((1,), jnp.float32))
    ign = tuple(np.asarray(x[0]) for x in (g0.q, g0.p, g0.v))
    frames = [(0.0, []) + observe(g0.q[0], g0.p[0], lms, NOISE_PX, rng)]
    t_prev, n_imu = 0.0, int(IMU_HZ / CAM_HZ)
    for k in range(1, int(DURATION * CAM_HZ) + 1):
        t = k / CAM_HZ
        tm = t_prev + (np.arange(n_imu) + 0.5) / IMU_HZ
        s = traj.sample(jnp.asarray(tm, jnp.float32))
        imu = [(float(tm[i]), np.asarray(s.w_body[i]),
                np.asarray(s.a_body[i])) for i in range(n_imu)]
        gk = traj.sample(jnp.asarray([t], jnp.float32))
        frames.append((t, imu) + observe(gk.q[0], gk.p[0], lms, NOISE_PX,
                                         rng))
        t_prev = t
    return ign, frames


def _capture(sm, log):
    send = sm.send_transaction

    def captured(txn):
        log.append(txn)
        return send(txn)
    sm.send_transaction = captured


class Side:
    """One package's smoother, inertial odometry and visual odometry."""

    def __init__(self, pkg, params):
        gn, sm_mod, io_mod, vo_mod, self.Meas = pkg
        dev = {} if pkg[0] is jgn else {"device": "cpu"}
        self.sm = sm_mod.FixedLagSmoother(sm_mod.SmootherConfig(
            **SMOOTHER, solver=gn.SolverOptions(max_iterations=8)), **dev)
        self.sm.register_extrinsic("cam0", np.asarray(Q_BC),
                                   np.asarray(P_BC))
        self.io = io_mod.InertialOdometry(self.sm, io_mod.ImuParams(),
                                          **dev)
        self.vo = vo_mod.VisualOdometry(
            self.sm, CAM if pkg[0] is jgn else _port_cam(),
            vo_mod.VOParams(**params), sensor_name="cam0",
            trigger_cb=lambda t: self.io.process_trigger(t),
            frame_initializer=lambda t: self.io.model.get_pose(t)[:2])
        self.txns = []
        _capture(self.sm, self.txns)
        if self.vo.local_smoother is not None:
            _capture(self.vo.local_smoother, self.txns)
        self.sm_mod = sm_mod

    def ignite(self, q, p, v):
        txn = self.sm_mod.Transaction(stamp=0.0)
        txn.add_imu_state(0.0, q, p, v)
        txn.add_imu_prior(0.0, q, p, v, np.zeros(3), np.zeros(3),
                          1e3 * np.eye(15, dtype=np.float32))
        self.sm.send_transaction(txn)
        self.sm.run_once()
        self.io.initialize(0.0, q, p, v)
        self.vo.initialize(0.0)

    def frame(self, t, imu, ids, pix):
        for ti, w, a in imu:
            self.io.process_imu(ti, w, a)
        n0 = len(self.txns)
        kf = self.vo.process_measurements(self.Meas(t, ids, pix, pix))
        if kf:
            self.sm.run_once()
        return kf, self.txns[n0:]

    def graph_lms(self):
        return self.vo.graph.lm_active.sum()

    def window(self, sm=None):
        sm = sm or self.sm
        return {t: sm.get_state(t) for t in sm.current_stamps()}


def _port_cam():
    from beam_slam_tpu_torch.vision.camera import PinholeRadtan
    return PinholeRadtan(*CAM[:4])


JAX = (jgn, jsm, jio, jvo, JMeas)
PORT = (tgn, tsm, tio, tvo, TMeas)


def assert_same_txn(a, b, label):
    assert a.stamp == b.stamp, label
    assert [s.stamp for s in a.imu_states] == \
        [s.stamp for s in b.imu_states], label
    for x, y in zip(a.imu_states, b.imu_states):
        assert float(np.linalg.norm(x.p - y.p)) < POS_TOL, label
        assert _rot_err(x.q, y.q) < ROT_TOL, label
    assert [l.lm_id for l in a.landmarks] == \
        [l.lm_id for l in b.landmarks], label
    for x, y in zip(a.landmarks, b.landmarks):
        if x.position[1:].any():       # Euclidean
            assert float(np.linalg.norm(x.position - y.position)) \
                < POS_TOL, (label, x.lm_id)
        else:                          # inverse depth
            assert abs(x.position[0] - y.position[0]) \
                < 1e-3 * abs(x.position[0]), (label, x.lm_id)
    for fa, fb in ((a.reprojections, b.reprojections),
                   (a.idp_reprojections, b.idp_reprojections)):
        keys = ("anchor_stamp", "stamp", "lm_id", "sensor")
        assert [tuple(getattr(f, k, None) for k in keys) for f in fa] == \
            [tuple(getattr(f, k, None) for k in keys) for f in fb], label
        for x, y in zip(fa, fb):
            np.testing.assert_allclose(y.pixel, x.pixel, atol=PIX_TOL)
            np.testing.assert_array_equal(y.intr, x.intr)
            np.testing.assert_array_equal(y.sqrt_info, x.sqrt_info)
            if hasattr(x, "bearing"):
                np.testing.assert_allclose(y.bearing, x.bearing,
                                           atol=PIX_TOL / CAM.fx)
    assert [(r.stamp_i, r.stamp_j) for r in a.rel_poses] == \
        [(r.stamp_i, r.stamp_j) for r in b.rel_poses], label
    for x, y in zip(a.rel_poses, b.rel_poses):
        assert float(np.linalg.norm(x.dp - y.dp)) < POS_TOL, label
        assert _rot_err(x.dq, y.dq) < ROT_TOL, label
        np.testing.assert_allclose(y.sqrt_info, x.sqrt_info, rtol=1e-6)
    assert [p.stamp for p in a.abs_poses] == [p.stamp for p in b.abs_poses]


def assert_same_window(wa, wb, label):
    assert sorted(wa) == sorted(wb), label
    for t in wa:
        dp = float(np.linalg.norm(wa[t]["p"] - wb[t]["p"]))
        assert dp < POS_TOL, (label, t, dp)
        assert _rot_err(wa[t]["q"], wb[t]["q"]) < ROT_TOL, (label, t)


def _window(w):
    return {t: dict(p=np.asarray(x["p"]), q=np.asarray(x["q"]))
            for t, x in w.items()}


def jax_run(params):
    """The reference's side of the session: after every frame its keyframe
    flag, the transactions it sent and its window(s); at the end what the
    tests read of its odometry and graph."""
    ign, frames = make_stream()
    side = Side(JAX, params)
    side.ignite(*ign)
    per = []
    for t, imu, ids, pix in frames:
        kf, txns = side.frame(t, imu, ids, pix)
        local = side.vo.local_smoother
        per.append(dict(kf=kf, txns=[dataclasses.asdict(x) for x in txns],
                        window=_window(side.window()),
                        local=None if local is None
                        else _window(side.window(local))))
    sm = side.sm
    return dict(
        frames=per, keyframes=list(side.vo.keyframes),
        failures=side.vo.failures, reset_count=side.vo.reset_count,
        lm_active=np.asarray(sm.lm_active).copy(),
        state_active=np.asarray(sm.state_active).copy(),
        slot_of_lm_id=dict(sm.slot_of_lm_id), counters=dict(sm.counters),
        arenas={n: np.asarray(getattr(sm, n).active).copy()
                for n in ("arena_reproj", "arena_idp", "arena_rel")},
        lm_pt=np.asarray(sm.lm_pt).copy())


def _namespace(x):
    """A recorded transaction as attributes, as the reference's is."""
    if isinstance(x, dict):
        return types.SimpleNamespace(**{k: _namespace(v)
                                        for k, v in x.items()})
    if isinstance(x, list):
        return [_namespace(v) for v in x]
    return x


def run_pair(params, ref):
    """The port's side of the session against the reference's (``ref``,
    as jax_run gives it): after every frame the same keyframe decision and
    transactions, the same window(s)."""
    ign, frames = make_stream()
    side = Side(PORT, params)
    side.ignite(*ign)
    n_kf = peak_lm = 0
    for (t, imu, ids, pix), rj in zip(frames, ref["frames"]):
        kt, tt = side.frame(t, imu, ids, pix)
        label = f"frame {t}"
        assert rj["kf"] == kt, label
        assert len(rj["txns"]) == len(tt), label
        for a, b in zip(rj["txns"], tt):
            assert_same_txn(_namespace(a), b, label)
        assert_same_window(rj["window"], side.window(), label)
        if rj["local"] is not None:
            assert_same_window(rj["local"],
                               side.window(side.vo.local_smoother), label)
        n_kf += rj["kf"]
        peak_lm = max(peak_lm, int(side.graph_lms()))
    return side, n_kf, peak_lm


@pytest.mark.parametrize("landmark_type", ["EUC", "IDP"])
def test_vo_session_matches_reference(landmark_type):
    j = jax_recording.load(RECORDING)[landmark_type]
    t, n_kf, peak_lm = run_pair(dict(VO, landmark_type=landmark_type), j)
    assert n_kf >= 4 and t.vo.keyframes == j["keyframes"]
    assert t.vo.failures == j["failures"]
    assert t.vo.reset_count == j["reset_count"]
    for name in ("lm_active", "state_active"):
        np.testing.assert_array_equal(getattr(t.sm, name), j[name],
                                      err_msg=name)
    assert t.sm.slot_of_lm_id == j["slot_of_lm_id"]
    assert t.sm.counters == j["counters"]
    arena = "arena_idp" if landmark_type == "IDP" else "arena_reproj"
    np.testing.assert_array_equal(getattr(t.sm, arena).active,
                                  j["arenas"][arena])
    # the map was built (IDP landmarks leave with their anchor keyframe)
    # and the window slid past its first states
    assert peak_lm >= 20
    assert t.sm._last_marginalized_stamps and 0.0 not in t.sm.slot_of_stamp
    for lm_id, s in t.sm.slot_of_lm_id.items():
        assert float(np.linalg.norm(t.sm.lm_pt[s] - j["lm_pt"][s])) \
            < POS_TOL * max(1.0, float(np.abs(j["lm_pt"][s]).max())), lm_id


@pytest.mark.slow
def test_recording_is_the_jax_packages_session():
    """The reference's sessions run again equal their recording."""
    jax_recording.assert_same(jax_recording.encode_roundtrip(_record_all()),
                              jax_recording.load(RECORDING))


@pytest.mark.slow
def test_vo_standalone_matches_reference():
    """Standalone mode (tests/test_vo_standalone.py:20): the visual BA in a
    private graph, relative-pose factors to the main graph; both graphs
    the same on both sides after every frame. Slow (~40 s on the CPU, most
    of it compiling the reference's two graphs); LVIO and VIO do not run
    standalone mode."""
    params = dict(VO, standalone=True)
    j = jax_run(params)
    t, n_kf, peak_lm = run_pair(params, j)
    assert n_kf >= 4
    assert t.sm.lm_active.sum() == 0 and t.sm.arena_reproj.active.sum() == 0
    assert peak_lm >= 20
    assert t.sm.arena_rel.active.sum() >= 2
    np.testing.assert_array_equal(t.sm.arena_rel.active,
                                  j["arenas"]["arena_rel"])


def test_vo_fallback_and_failure_counter_matches_reference():
    """tests/test_vio_e2e.py:127: with no landmarks the localization falls
    back to the seed and counts failures, up to the reset."""
    sides = []
    for pkg in (JAX, PORT):
        gn, sm_mod, _, vo_mod, Meas = pkg
        dev = {} if pkg is JAX else {"device": "cpu"}
        sm = sm_mod.FixedLagSmoother(sm_mod.SmootherConfig(max_states=8),
                                     **dev)
        sm.register_extrinsic("cam0", np.asarray(Q_BC), np.asarray(P_BC))
        vo = vo_mod.VisualOdometry(
            sm, CAM if pkg is JAX else _port_cam(),
            vo_mod.VOParams(max_failures_before_reset=3),
            frame_initializer=lambda t: (np.array([1, 0, 0, 0], np.float32),
                                         np.full(3, t, np.float32)))
        vo.initialize(0.0)
        sides.append((vo, Meas))
    for k in range(1, 6):
        for vo, Meas in sides:
            vo.process_measurements(Meas(
                0.1 * k, np.arange(5), np.zeros((5, 2), np.float32),
                np.zeros((5, 2), np.float32)))
        (vj, _), (vt, _) = sides
        assert (vt.failures, vt.reset_count) == (vj.failures, vj.reset_count)
        (tj, qj, pj), (tt, qt, pt) = vj.odometry_log[-1], vt.odometry_log[-1]
        assert tj == tt and np.array_equal(pt, pj) and np.array_equal(qt, qj)
        np.testing.assert_allclose(pt, np.full(3, 0.1 * k), rtol=1e-6)
    assert vt.reset_count == 1 and vt.failures == 2


def _record_all():
    return {lt: jax_run(dict(VO, landmark_type=lt)) for lt in ("EUC", "IDP")}


if __name__ == "__main__" and sys.argv[1:] == ["record"]:
    print(jax_recording.save(RECORDING, _record_all()))
