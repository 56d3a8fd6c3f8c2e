"""Parity of the port's exact marginalization (FixedLagSmoother with
pseudo_marginalization=False) with the JAX reference.

A chain of IMU states with preintegrated IMU, relative-pose, gravity and
absolute-pose factors is fed into a JAX smoother on the host (transactions
applied, windows expired, no solve: the states stay at their perturbed
seeds). Before each marginalizing step its host state is copied into a port
smoother (bridge.smoother_from_numpy); both then apply the same transaction
and expire the lag window, which Schur-eliminates the stale states in
float64 into a dense MarginalPrior factor.

What is held, per marginalizing step:
  * the normal equations of the involved factors, the float64 step's input,
    at tests/test_torch_solver.py's assembly bound (float32 scatter-adds in
    another order): 1e-5 of each array's largest magnitude plus rtol 1e-4;
  * the float64 step itself: the port's ``schur_marginal`` on the
    reference's normal equations gives the reference's A and b within 1e-4
    of max|A|; slots and linearization points are equal;
  * end to end, each side from its own normal equations: A and b within
    1e-4 of max|A|.
"""

import copy

import numpy as np
import numpy.testing as npt
import pytest
import torch

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

RATE, KF_DT, N_KF, SEED = 200.0, 0.5, 8, 3
CFG = dict(lag_duration=1.5, pseudo_marginalization=False, max_states=24,
           max_imu_factors=48, max_prior_factors=8, max_rel_pose_factors=8,
           max_abs_pose_factors=8, max_gravity_factors=8,
           max_motion_factors=8)


def _txns(m):
    """The chain's transactions for module ``m`` (the same numbers each
    call)."""
    rng = np.random.default_rng(SEED)
    traj = jsim.AnalyticTrajectory()
    noise = jpre.PreintNoise.isotropic(1e-4, 1e-3, 1e-6, 1e-5)
    times = KF_DT * np.arange(N_KF)
    s = traj.sample(jnp.asarray(times, jnp.float32))
    q, p, v = (np.asarray(x) for x in (s.q, s.p, s.v))
    eye = lambda n, w: (w * np.eye(n)).astype(np.float32)  # noqa: E731
    out = [m.Transaction(stamp=0.0).add_imu_state(0.0, q[0], p[0], v[0])
           .add_imu_prior(0.0, q[0], p[0], v[0], np.zeros(3), np.zeros(3),
                          eye(15, 1e3))]
    for i in range(1, N_KF):
        t0, t1 = float(times[i - 1]), float(times[i])
        n = int(round(KF_DT * RATE))
        tm = t0 + (np.arange(n) + 0.5) / RATE
        si = traj.sample(jnp.asarray(tm, jnp.float32))
        d = jpre.preintegrate_np(np.full(n, 1.0 / RATE), np.asarray(si.w_body),
                                 np.asarray(si.a_body), np.zeros(3),
                                 np.zeros(3), noise)
        dq = lie_np.so3_exp_quat((0.03 * rng.standard_normal(3))
                                 .astype(np.float32))
        txn = m.Transaction(stamp=t1)
        txn.add_imu_state(t1, lie_np.quat_mul(q[i], dq),
                          p[i] + 0.03 * rng.standard_normal(3),
                          v[i] + 0.03 * rng.standard_normal(3))
        txn.add_imu_relative(t0, t1, d, np.zeros(3), np.zeros(3))
        rq = lie_np.quat_mul(lie_np.quat_conj(q[i - 1]), q[i])
        rp = lie_np.quat_rotate(lie_np.quat_conj(q[i - 1]), p[i] - p[i - 1])
        txn.add_relative_pose(t0, t1, rq, rp, eye(6, 1e2))
        txn.add_gravity(t1, lie_np.quat_rotate(
            lie_np.quat_conj(q[i]), np.array([0, 0, -1.0], np.float32)),
            eye(2, 2.0))
        if i % 3 == 0:
            txn.add_abs_pose(t1, q[i], p[i], eye(6, 10.0))
        out.append(txn)
    return out


def _fields(sm):
    """A snapshot of the smoother's host state, as the bridge takes it."""
    fields = {n: getattr(sm, n) for n in bridge.SMOOTHER_FIELDS}
    for n in bridge.ARENAS:
        a = getattr(sm, n)
        fields[n] = {f: getattr(a, f) for f in bridge.ARENA_FIELDS}
    fields["stamps"] = sm.current_stamps()
    return copy.deepcopy(fields)


def _captured(monkeypatch):
    """Record every exact marginalization's normal equations (both sides)
    and the port's arguments of its float64 step."""
    cap = dict(j=[], t=[], schur=[])
    for mod, key in ((jgn, "j"), (tgn, "t")):
        fn = mod.assemble_normal_equations_jit

        def wrapped(w, f, l, fn=fn, key=key):
            out = fn(w, f, l)
            cap[key].append([np.asarray(a, np.float64) for a in out[:5]])
            return out
        monkeypatch.setattr(mod, "assemble_normal_equations_jit", wrapped)
    schur = tsm.schur_marginal

    def schur_wrapped(*args):
        cap["schur"].append(args[5:])
        return schur(*args)
    monkeypatch.setattr(tsm, "schur_marginal", schur_wrapped)
    return cap


def _tick(sm, txn):
    sm.send_transaction(txn)
    sm._process_queue()
    sm._marginalize()


@pytest.fixture(scope="module")
def steps():
    """[(JAX state, port state, captured)] after every marginalizing
    step."""
    with pytest.MonkeyPatch.context() as mp:
        return _steps(mp)


def _steps(monkeypatch):
    cfg_t = tsm.SmootherConfig(**CFG, solver=tgn.SolverOptions())
    sj = jsm.FixedLagSmoother(jsm.SmootherConfig(
        **CFG, solver=jgn.SolverOptions()))
    out = []
    cap = _captured(monkeypatch)
    for txn_j, txn_t in zip(_txns(jsm), _txns(tsm)):
        stale_before = len(sj._last_marginalized_stamps)
        st = bridge.smoother_from_numpy(cfg_t, _fields(sj), "cpu")
        for v in cap.values():
            v.clear()
        _tick(sj, txn_j)
        _tick(st, txn_t)
        if len(sj._last_marginalized_stamps) > stale_before:
            out.append((_fields(sj), _fields(st), copy.deepcopy(cap)))
    return out


def _new_factor(fj, ft):
    """The marginal factor this step wrote: (A, b) of each side (the
    arena entry with the newest insertion)."""
    mj, mt = fj["arena_marg"], ft["arena_marg"]
    live = np.nonzero(mj["active"])[0]
    i = live[np.argmax(mj["seq"][live])]
    return i, [(m["fields"]["A"][i], m["fields"]["b"][i]) for m in (mj, mt)]


def test_exact_marginal_prior_matches_reference(steps):
    assert len(steps) >= 3
    for k, (fj, ft, cap) in enumerate(steps):
        assert fj["stamps"] == ft["stamps"], k
        assert len(cap["j"]) == len(cap["t"]) == len(cap["schur"]) == 1, k
        mj, mt = fj["arena_marg"], ft["arena_marg"]
        npt.assert_array_equal(mt["active"], mj["active"])
        npt.assert_array_equal(mt["slots"], mj["slots"])
        live = np.nonzero(mj["active"])[0]
        # the float64 step's input: the involved factors' normal equations
        for name, a, b in zip(("H", "g", "H_ll", "g_l", "W"), cap["j"][0],
                              cap["t"][0]):
            npt.assert_allclose(b, a, rtol=1e-4,
                                atol=1e-5 * max(1.0, np.abs(a).max()),
                                err_msg=f"step {k} {name}")
        i, ((A_j, b_j), (A_t, b_t)) = _new_factor(fj, ft)
        scale = float(np.abs(A_j).max())
        assert scale > 0
        # the float64 step on the reference's normal equations
        H, g, H_ll, g_l, W = cap["j"][0]
        A_r, b_r = tsm.schur_marginal(H[:-1, :-1], g[:-1], H_ll, g_l,
                                      W[:-1], *cap["schur"][0])
        nr = A_r.shape[0]
        npt.assert_allclose(A_r, A_j[:nr, :nr], rtol=0, atol=1e-4 * scale,
                            err_msg=f"step {k} A")
        npt.assert_allclose(b_r, b_j[:nr], rtol=0, atol=1e-4 * scale,
                            err_msg=f"step {k} b")
        # end to end
        npt.assert_allclose(A_t, A_j, rtol=0, atol=1e-4 * scale)
        npt.assert_allclose(b_t, b_j, rtol=0, atol=1e-4 * scale)
        for name in ("q_lin", "p_lin", "v_lin", "bg_lin", "ba_lin"):
            npt.assert_array_equal(mt["fields"][name][live],
                                   mj["fields"][name][live], err_msg=name)
        assert ft["counters"] == fj["counters"]
        assert ft["_last_marginalized_stamps"] == \
            fj["_last_marginalized_stamps"]
