"""Parity of the port's fixed-lag smoother (beam_slam_tpu_torch.solver.
smoother, sync tick) with the JAX reference.

One short session at tests/test_smoother.py::make_smoother's capacities
(lag 2 s, a keyframe every 0.5 s, so states are pseudo-marginalized) feeds
the same transactions, built once on the host, into both smoothers:
ignition, preintegrated IMU factors, relative-pose factors (Cauchy-robust),
gravity factors and absolute poses, and three robustness events — a
transaction on an unknown stamp (blacklisted, retried, then dropped at its
timeout), one that references a marginalized stamp (scrubbed) and a solve
time budget of 1e-9 s (downshifts). The LM loop stops at convergence
(early_exit) on both sides.

Per tick: the same window stamps, slots, factor activity and counters;
positions within 1e-3 m and rotations within 1e-3 rad; the initial and
final cost within rtol 1e-3 (float32 assembly in another order, then up to
8 LM steps, each accept/reject decided on costs that agree to ~1e-6).

Also: the bridge's copy of a JAX smoother's host state (after which one
more tick on each side agrees as above), and the hand-built configs/lio.yaml
smoother configuration of chip_smoke.py against the JAX package's.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.imu import preintegration as jpre
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu.utils import sim as jsim
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import lie_np
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RATE = 200.0
KF_DT, N_TICKS, SEED = 0.5, 9, 3
POS_TOL, ROT_TOL, COST_RTOL = 1e-3, 1e-3, 1e-3
CFG = dict(lag_duration=2.0, max_states=16, max_imu_factors=32,
           max_prior_factors=8, max_rel_pose_factors=8,
           max_abs_pose_factors=8, max_gravity_factors=8,
           cauchy_loss_rel_pose=1.0, transaction_timeout=0.3,
           max_solver_time_s=1e-9, downshift_scan_length=8,
           downshift_hold_ticks=2)
SOLVER = dict(max_iterations=8, early_exit=True)
ARENA_NAMES = bridge.ARENAS


def _configs():
    return (jsm.SmootherConfig(**CFG, solver=jgn.SolverOptions(**SOLVER)),
            tsm.SmootherConfig(**CFG, solver=tgn.SolverOptions(**SOLVER)))


def _sample(traj, t):
    s = traj.sample(jnp.asarray(np.atleast_1d(t), jnp.float32))
    return tuple(np.asarray(x) for x in (s.q, s.p, s.v))


def _segment(traj, noise, t0, t1):
    """Exact IMU at interval midpoints over [t0, t1], preintegrated by the
    reference's host mirror (the same numbers go to both sides)."""
    n = int(round((t1 - t0) * RATE))
    dt = (t1 - t0) / n
    s = traj.sample(jnp.asarray(t0 + (np.arange(n) + 0.5) * dt, jnp.float32))
    return jpre.preintegrate_np(np.full(n, dt), np.asarray(s.w_body),
                                np.asarray(s.a_body), np.zeros(3),
                                np.zeros(3), noise)


def _transactions():
    """Per tick, the (callable) transactions to send: each builds a fresh
    Transaction of the given module, so both sides get equal ones."""
    rng = np.random.default_rng(SEED)
    traj = jsim.AnalyticTrajectory()
    noise = jpre.PreintNoise.isotropic(1e-4, 1e-3, 1e-6, 1e-5)
    times = KF_DT * np.arange(N_TICKS + 1)
    q, p, v = _sample(traj, times)
    eye = lambda n, w: (w * np.eye(n)).astype(np.float32)  # noqa: E731
    ticks = []

    ign = lambda m: [m.Transaction(stamp=0.0, sensor_id="init")  # noqa: E731
                     .add_imu_state(0.0, q[0], p[0], v[0])
                     .add_imu_prior(0.0, q[0], p[0], v[0], np.zeros(3),
                                    np.zeros(3), eye(15, 1e3))]
    ticks.append(ign)
    for i in range(1, N_TICKS + 1):
        t0, t1 = float(times[i - 1]), float(times[i])
        d = _segment(traj, noise, t0, t1)
        dq = lie_np.quat_mul(q[i], lie_np.so3_exp_quat(
            (0.05 * rng.standard_normal(3)).astype(np.float32)))
        dp = p[i] + 0.05 * rng.standard_normal(3)
        dv = v[i] + 0.05 * rng.standard_normal(3)
        # relative pose i-1 → i from ground truth, with noise
        rq = lie_np.quat_mul(lie_np.quat_conj(q[i - 1]), q[i])
        rq = lie_np.quat_mul(rq, lie_np.so3_exp_quat(
            (0.002 * rng.standard_normal(3)).astype(np.float32)))
        rp = lie_np.quat_rotate(lie_np.quat_conj(q[i - 1]), p[i] - p[i - 1]) \
            + 0.002 * rng.standard_normal(3)
        g_body = lie_np.quat_rotate(lie_np.quat_conj(q[i]),
                                    np.array([0.0, 0.0, -1.0], np.float32))
        spec = dict(t0=t0, t1=t1, d=d, dq=dq, dp=dp, dv=dv, rq=rq, rp=rp,
                    g_body=g_body, abs=(i % 3 == 0), qi=q[i], pi=p[i])

        def tick(m, s=spec, i=i):
            txn = m.Transaction(stamp=s["t1"], sensor_id="imu")
            txn.add_imu_state(s["t1"], s["dq"], s["dp"], s["dv"])
            txn.add_imu_relative(s["t0"], s["t1"], s["d"], np.zeros(3),
                                 np.zeros(3))
            txn.add_relative_pose(s["t0"], s["t1"], s["rq"], s["rp"],
                                  eye(6, 1e2))
            txn.add_gravity(s["t1"], s["g_body"], eye(2, 2.0))
            if s["abs"]:
                txn.add_abs_pose(s["t1"], s["qi"], s["pi"], eye(6, 10.0))
            out = [txn]
            if i == 3:  # an unknown stamp: blacklisted, retried, dropped
                out.append(m.Transaction(stamp=1.25, sensor_id="lidar")
                           .add_relative_pose(1.1, 1.25,
                                              np.array([1, 0, 0, 0.0]),
                                              np.zeros(3), eye(6, 1.0)))
            if i == 8:  # a marginalized stamp (scrubbed) beside a valid one
                scrub = m.Transaction(stamp=s["t1"], sensor_id="lidar")
                scrub.add_abs_pose(0.5, np.array([1, 0, 0, 0.0]),
                                   np.zeros(3), eye(6, 1.0))
                scrub.add_abs_pose(s["t1"], s["qi"], s["pi"], eye(6, 10.0))
                out.append(scrub)
            return out
        ticks.append(tick)
    return ticks, dict(zip(times.tolist(), zip(q, p)))


def _state(sm):
    return dict(
        stamps=sm.current_stamps(), slots=dict(sm.slot_of_stamp),
        counters=dict(sm.counters), pending=len(sm._pending),
        blacklist=set(sm.blacklisted_sensors),
        active={n: getattr(sm, n).active.copy() for n in ARENA_NAMES},
        p={t: sm.get_state(t)["p"] for t in sm.current_stamps()},
        q={t: sm.get_state(t)["q"] for t in sm.current_stamps()})


def _cost(diag):
    return (float(diag.initial_cost), float(diag.final_cost),
            int(diag.iterations))


def _assert_ticks_agree(a, b, da, db, label):
    for k in ("stamps", "slots", "counters", "pending", "blacklist"):
        assert a[k] == b[k], (label, k, a[k], b[k])
    for n in ARENA_NAMES:
        npt.assert_array_equal(a["active"][n], b["active"][n],
                               err_msg=f"{label} {n}")
    for t in a["stamps"]:
        assert np.linalg.norm(a["p"][t] - b["p"][t]) < POS_TOL, (label, t)
        dq = lie_np.quat_mul(lie_np.quat_conj(a["q"][t].astype(np.float64)),
                             b["q"][t].astype(np.float64))
        assert np.linalg.norm(lie_np.so3_log(dq)) < ROT_TOL, (label, t)
    if da is None or db is None:
        assert da is None and db is None, label
        return
    npt.assert_allclose(_cost(da)[:2], _cost(db)[:2], rtol=COST_RTOL,
                        err_msg=label)


def _smoother_fields(sm):
    fields = {n: getattr(sm, n) for n in bridge.SMOOTHER_FIELDS}
    for n in ARENA_NAMES:
        a = getattr(sm, n)
        fields[n] = {f: getattr(a, f) for f in bridge.ARENA_FIELDS}
    return fields


@pytest.fixture(scope="module")
def session():
    ticks, gt = _transactions()
    cfg_j, cfg_t = _configs()
    sj, st = jsm.FixedLagSmoother(cfg_j), tsm.FixedLagSmoother(cfg_t, "cpu")
    out = []
    for tick in ticks[:-1]:
        for txn in tick(jsm):
            sj.send_transaction(txn)
        for txn in tick(tsm):
            st.send_transaction(txn)
        dj, dt = sj.run_once(), st.run_once()
        out.append((_state(sj), _state(st), dj, dt))
    return dict(ticks=ticks, gt=gt, sj=sj, st=st, out=out, cfg_t=cfg_t)


def test_session_ticks_match_reference(session):
    out = session["out"]
    assert len(out) == N_TICKS
    for k, (a, b, da, db) in enumerate(out):
        _assert_ticks_agree(a, b, da, db, f"tick {k}")
    last = out[-1][1]
    assert min(last["stamps"]) > 0.5  # states were marginalized
    assert last["active"]["arena_prior"].sum() >= 1   # window-start prior
    for t in last["stamps"]:  # and the window tracks ground truth
        assert np.linalg.norm(last["p"][t] - session["gt"][t][1]) < 0.05


def test_robustness_counters_match_reference(session):
    """Blacklist and retry, the timeout drop, the scrub and the solve-time
    downshifts happened, and identically on both sides (tick 3 on)."""
    out = session["out"]
    jax_side = [a for a, *_ in out]
    port_side = [b for _, b, *_ in out]
    assert [s["counters"] for s in jax_side] == \
        [s["counters"] for s in port_side]
    assert "lidar" in port_side[3]["blacklist"] and port_side[3]["pending"]
    final = port_side[-1]["counters"]
    assert final["dropped_transactions"] == 1
    assert final["scrubbed_factors"] >= 1
    assert final["solve_downshifts"] >= 2
    assert port_side[-1]["pending"] == 0


def test_smoother_from_numpy_round_trip(session):
    """The bridge's copy holds the JAX smoother's host state exactly; one
    more tick on each side then agrees as the session's ticks do."""
    sj = session["sj"]
    st = bridge.smoother_from_numpy(session["cfg_t"], _smoother_fields(sj),
                                    "cpu")
    for name in bridge.SMOOTHER_FIELDS:
        a, b = getattr(sj, name), getattr(st, name)
        if isinstance(a, np.ndarray):
            npt.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b or (a != a and b != b), name
    for n in ARENA_NAMES:
        ja, ta = getattr(sj, n), getattr(st, n)
        for f in ("slots", "active", "seq"):
            npt.assert_array_equal(getattr(ta, f), getattr(ja, f))
        assert ta._free == ja._free and ta._next_seq == ja._next_seq
        for k, v in ja.fields.items():
            npt.assert_array_equal(ta.fields[k], v, err_msg=f"{n}.{k}")
    last = session["ticks"][-1]
    for txn in last(jsm):
        sj.send_transaction(txn)
    for txn in last(tsm):
        st.send_transaction(txn)
    dj, dt = sj.run_once(), st.run_once()
    _assert_ticks_agree(_state(sj), _state(st), dj, dt, "after the copy")


@pytest.mark.parametrize("max_skipped,force_skip", [(0, 0), (2, 2)])
def test_async_tick_matches_reference(monkeypatch, max_skipped, force_skip):
    """The double-buffered tick (async_solve) on both sides over the same
    session: after every tick the same stamps, counters, pending queue and
    returned diagnostics (each tick returns the previous solve's, or None
    on a skipped tick), states within the session's tolerances; then the
    flushed last solve. With async_max_skipped_ticks=2 and
    BEAM_SLAM_ASYNC_FORCE_SKIP=2 both skip two ticks and block-harvest on
    the third, on both sides the same sequence."""
    monkeypatch.setenv("BEAM_SLAM_ASYNC_FORCE_SKIP", str(force_skip))
    ticks, gt = _transactions()
    cfg_j, cfg_t = (dataclasses.replace(c, async_solve=True,
                                        async_max_skipped_ticks=max_skipped)
                    for c in _configs())
    sj, st = jsm.FixedLagSmoother(cfg_j), tsm.FixedLagSmoother(cfg_t, "cpu")
    harvests = []
    for k, tick in enumerate(ticks[:-1]):
        for txn in tick(jsm):
            sj.send_transaction(txn)
        for txn in tick(tsm):
            st.send_transaction(txn)
        dj, dt = sj.run_once(), st.run_once()
        if sj._inflight is not None:
            # the reference's dispatched solve reads host buffers that the
            # next skipped tick's ingestion overwrites in place; wait for it
            # so that it solves the problem it was given (ROADMAP Queue 3)
            jax.block_until_ready(sj._inflight[0])
        _assert_ticks_agree(_state(sj), _state(st), dj, dt, f"tick {k}")
        assert sj.solve_count == st.solve_count
        assert sj.last_solved_stamp == st.last_solved_stamp
        harvests.append(dt is not None)
    dj, dt = sj.flush(), st.flush()
    _assert_ticks_agree(_state(sj), _state(st), dj, dt, "flush")
    assert st._inflight is None and dt is not None
    if max_skipped:
        # dispatch, skip, skip, harvest+dispatch, ...: the states ingested
        # while a solve was in flight keep their seeds until a later solve
        assert harvests == [False, False, False, True, False, False, True,
                            False, False][:len(harvests)]
        return
    assert harvests == [False] + [True] * (len(harvests) - 1)
    last = _state(st)
    for t in last["stamps"]:  # every state solved: the window tracks truth
        assert np.linalg.norm(last["p"][t] - gt[t][1]) < 0.05


def test_lio_config_matches_reference():
    """chip_smoke.py's configs/lio.yaml smoother configuration of phase 10
    equals the JAX LocalMapperConfig's, field by field, but for the one
    stated reduction: the sync tick (async_solve False where the reference
    defaults to its async tick)."""
    from beam_slam_tpu.pipeline.config import LocalMapperConfig
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lm = LocalMapperConfig.from_yaml(str(ROOT / "configs" / smoke.LIO_YAML))
    ref, out = lm.smoother_config(), smoke.lio_smoother_config()
    assert lm.mode == "LIO" and ref.async_solve and not out.async_solve
    for f in dataclasses.fields(ref):
        if f.name in ("async_solve", "solver"):
            continue
        assert getattr(out, f.name) == getattr(ref, f.name), f.name
    for name in tgn.SolverOptions._fields:
        assert getattr(out.solver, name) == getattr(ref.solver, name), name
    # the session's gravity factors are LocalMapper's
    assert lm.use_gravity_alignment
    assert smoke.LIO_GRAVITY["info_weight"] == lm.gravity_info_weight
    # 990 dense dof + the trash dof: a 1024² reduced system after padding
    dof = out.max_states * 15 + out.max_extrinsics * 6 + 6
    assert dof == 990 and (dof + 1 + 127) // 128 * 128 == 1024
