"""Parity of the port's LM solver (beam_slam_tpu_torch.solver.gauss_newton
and .batched) with the JAX reference on the same bridged inputs: normal
equations, the damped Schur-reduced system and its solve, the single-window
LM solve, and the shared-topology batched solve (whose reference run goes
through the Pallas Cholesky kernel, interpreted on the CPU).

Tolerances (float32 throughout, stated per comparison below):
  * assembly: scatter-adds in different order of values up to ~2e9 (the
    IMU factors' whitening), so 1e-5 of each array's largest magnitude
    plus rtol 1e-4 per entry;
  * the reduced system and its solve: the Schur complement subtracts
    products of that scale, then a Cholesky solve amplifies by the
    condition number, so 1e-4 of scale for the system and 2e-3 for δ;
  * full LM solves: 8 iterations of the above, each accept/reject decided
    on costs that agree to ~1e-6 relative, so the decisions (iterations,
    convergence latch) must be identical and states agree to 5e-4.
"""

import dataclasses

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.ops import mat3 as jmat3
from beam_slam_tpu.solver import batched as jbs
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.utils import synthetic
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.ops import mat3 as tmat3
from beam_slam_tpu_torch.solver import batched as tbs
from beam_slam_tpu_torch.solver import gauss_newton as tgn

torch.set_num_threads(2)

LOSSES = (None, None, 1.0, 2.0, 2.0)
CENSUS = dict(n_kf=6, kf_dt=0.25, with_vision=True, n_landmarks=16,
              obs_per_lm=3, n_idp=4)
PARTS = ("imu", "extrinsics", "landmarks", "motion")


def _flat(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _bridge(wj, fj):
    wt = bridge.window_from_numpy({k: _flat(getattr(wj, k)) for k in PARTS},
                                  "cpu")
    ft = tuple(bridge.family_from_numpy(type(f).__name__, _flat(f), "cpu")
               for f in fj)
    return wt, ft


def _close(out, ref, rel, name="", rtol=1e-4):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, name
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        npt.assert_array_equal(out, ref, err_msg=name)
        return
    scale = max(1.0, float(np.abs(ref).max()))
    npt.assert_allclose(out, ref, atol=rel * scale, rtol=rtol, err_msg=name)


def _close_window(out, ref, atol):
    for k in PARTS:
        for f, a in _flat(getattr(ref, k)).items():
            b = getattr(getattr(out, k), f).numpy()
            if a.dtype == np.bool_:
                npt.assert_array_equal(b, a, err_msg=f"{k}.{f}")
            else:
                npt.assert_allclose(b, a, atol=atol, err_msg=f"{k}.{f}")


@pytest.fixture(scope="module")
def problem():
    build = jax.jit(lambda k: synthetic.build_lvio_window(k, **CENSUS)[:2])
    wj, fj = jax.block_until_ready(build(jax.random.PRNGKey(0)))
    return (wj, fj) + _bridge(wj, fj)


@pytest.fixture(scope="module")
def equations(problem):
    wj, fj, _, _ = problem
    return jax.block_until_ready(jax.jit(
        lambda w, f: jgn.assemble_normal_equations(w, f, LOSSES))(wj, fj))


def _damped_inputs(wj, eqs, lam):
    H, g, H_ll, g_l, W, _ = eqs
    free = jnp.concatenate([wj.dense_free_mask(), jnp.zeros((1,), bool)])
    lm_free = wj.landmarks.active & ~wj.landmarks.held
    args_j = (H, g, free, jnp.float32(lam), H_ll, g_l, W, lm_free)
    args_t = tuple(torch.tensor(np.asarray(a)) for a in args_j)
    return args_j, args_t


def test_mat3_matches_reference():
    """Cofactor 3×3 inverse and solve on damped SPD blocks (as the Schur
    step feeds them): float32 adjugate over det, so 1e-5 of scale."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((64, 3, 3)).astype(np.float32)
    A = (M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    b = rng.standard_normal((64, 3)).astype(np.float32)
    _close(tmat3.inv3x3(torch.from_numpy(A)), jmat3.inv3x3(jnp.asarray(A)),
           1e-5, "inv3x3")
    _close(tmat3.solve3x3(torch.from_numpy(A), torch.from_numpy(b)),
           jmat3.solve3x3(jnp.asarray(A), jnp.asarray(b)), 1e-5, "solve3x3")


def test_assemble_matches_reference(problem, equations):
    _, _, wt, ft = problem
    out = tgn.assemble_normal_equations(wt, ft, LOSSES)
    for name, a, b in zip(("H", "g", "H_ll", "g_l", "W", "cost"),
                          equations, out):
        _close(b, a, 1e-5, name)


def test_total_cost_matches_reference(problem):
    wj, fj, wt, ft = problem
    ref = jax.jit(lambda w, f: jgn.total_cost(w, f, LOSSES))(wj, fj)
    _close(tgn.total_cost(wt, ft, LOSSES), ref, 1e-5, rtol=1e-5)


def test_damped_reduced_system_matches_reference(problem, equations):
    args_j, args_t = _damped_inputs(problem[0], equations, 1e-3)
    Hp_j, gp_j, ctx_j = jax.jit(jgn._damped_reduced_system)(*args_j)
    Hp_t, gp_t, ctx_t = tgn._damped_reduced_system(*args_t)
    assert Hp_t.shape == (128, 128)  # 115 dense dof padded to 128
    _close(Hp_t, Hp_j, 1e-4, "Hp")
    _close(gp_t, gp_j, 1e-4, "gp")
    for name, a, b in zip(("s", "freef", "lmf", "Hll_inv", "Wr", "g_l"),
                          ctx_j, ctx_t):
        _close(b, a, 1e-4, name)


def test_solve_damped_matches_reference(problem, equations):
    args_j, args_t = _damped_inputs(problem[0], equations, 1e-3)
    d_j, dl_j, ok_j = jax.jit(jgn._solve_damped)(*args_j)
    d_t, dl_t, ok_t = tgn._solve_damped(*args_t)
    assert bool(ok_j) and bool(ok_t)
    _close(d_t, d_j, 2e-3, "delta")
    _close(dl_t, dl_j, 2e-3, "delta_l")


def test_solve_matches_reference(problem):
    wj, fj, wt, ft = problem
    w_ref, d_ref = jax.block_until_ready(jgn.solve(
        wj, fj, LOSSES, jgn.SolverOptions(max_iterations=8)))
    w_out, d_out = tgn.solve(wt, ft, LOSSES,
                             tgn.SolverOptions(max_iterations=8))
    _close(d_out.initial_cost, d_ref.initial_cost, 0.0, rtol=1e-5)
    _close(d_out.final_cost, d_ref.final_cost, 0.0, rtol=1e-3)
    assert float(d_out.final_cost) < 0.01 * float(d_out.initial_cost)
    _close(d_out.iterations, d_ref.iterations, 0.0)
    _close(d_out.converged, d_ref.converged, 0.0)
    _close_window(w_out, w_ref, 5e-4)


def test_solve_batched_shared_matches_reference():
    build = jax.jit(jax.vmap(
        lambda k: synthetic.build_lvio_window(k, **CENSUS)[:2]))
    wj, fj = jax.block_until_ready(build(jax.random.split(
        jax.random.PRNGKey(3), 2)))
    wt, ft = _bridge(wj, fj)
    tbs.assert_shared_topology(ft)
    w_ref, d_ref = jax.block_until_ready(jbs.solve_batched_shared(
        wj, fj, LOSSES, jgn.SolverOptions(max_iterations=6),
        chol_backend="pallas"))
    w_out, d_out = tbs.solve_batched_shared(
        wt, ft, LOSSES, tgn.SolverOptions(max_iterations=6))
    _close(d_out.initial_cost, d_ref.initial_cost, 0.0, rtol=1e-5)
    _close(d_out.final_cost, d_ref.final_cost, 0.0, rtol=1e-3)
    _close(d_out.iterations, d_ref.iterations, 0.0)
    _close_window(w_out, w_ref, 5e-4)


def test_assert_shared_topology_rejects_mismatch(problem):
    _, _, _, ft = problem
    fams = [f.map(lambda t: torch.stack([t, t.clone()])) for f in ft]
    tbs.assert_shared_topology(fams)
    fams[0].slots[1, 0, 0] += 1  # window 1 differs
    with pytest.raises(ValueError, match="slots differ"):
        tbs.assert_shared_topology(fams)


def test_marginal_pose_covariance_matches_reference(problem):
    """Marginal 6×6 pose covariances of three slots from the Schur-reduced,
    equilibrated system: a float32 Cholesky on both sides (XLA's and
    LAPACK's), so 1e-3 of the largest entry."""
    wj, fj, wt, ft = problem
    slots = np.array([0, 2, 5])
    ref = np.asarray(jgn.marginal_pose_covariance(
        wj, fj, LOSSES, jnp.asarray(slots, jnp.int32)))
    out = tgn.marginal_pose_covariance(wt, ft, LOSSES, torch.tensor(slots))
    assert out.shape == (3, 6, 6)
    npt.assert_allclose(out.numpy(), ref, atol=1e-3 * np.abs(ref).max(),
                        rtol=0)


def _counted(ft):
    calls = [0]

    def assemble(w):
        calls[0] += 1
        return tgn.assemble_normal_equations(w, ft, LOSSES)
    return assemble, calls


def test_early_exit_matches_fixed_length_loop(problem):
    """Steps after the convergence latch are inert, so stopping there gives
    the fixed-length loop's window and diagnostics bit for bit, in fewer
    steps (one assembly per step, plus the first)."""
    _, _, wt, ft = problem
    opts = tgn.SolverOptions(max_iterations=25, function_tolerance=1e-3)
    runs = {}
    for early in (False, True):
        assemble, calls = _counted(ft)
        runs[early] = tgn.lm_loop(wt, assemble, opts.max_iterations,
                                  opts._replace(early_exit=early)) + (calls,)
    (w_f, d_f, c_f), (w_e, d_e, c_e) = runs[False], runs[True]
    assert bool(d_e.converged)
    assert c_f[0] == 26 and c_e[0] < c_f[0]
    for a, b in zip(d_e, d_f):
        assert torch.equal(a, b)
    for k in PARTS:
        for f in dataclasses.fields(getattr(w_f, k)):
            assert torch.equal(getattr(getattr(w_e, k), f.name),
                               getattr(getattr(w_f, k), f.name)), (k, f.name)


def test_scan_length_caps_the_steps(problem, monkeypatch):
    """solve runs min(max_iterations, scan_length) steps: with
    scan_length=3 it is the 3-step solve."""
    _, _, wt, ft = problem
    seen = []
    lm_loop = tgn.lm_loop
    monkeypatch.setattr(tgn, "lm_loop", lambda w, a, n, o: seen.append(n)
                        or lm_loop(w, a, n, o))
    w_c, d_c = tgn.solve(wt, ft, LOSSES, tgn.SolverOptions(
        max_iterations=10, scan_length=3))
    w_3, d_3 = tgn.solve(wt, ft, LOSSES, tgn.SolverOptions(max_iterations=3))
    assert seen == [3, 3]
    for a, b in zip(d_c, d_3):
        assert torch.equal(a, b)
    assert torch.equal(w_c.imu.p, w_3.imu.p)
