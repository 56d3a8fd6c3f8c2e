"""Parity of the port's trajectory simulator, IMU preintegration and
synthetic LVIO builder (beam_slam_tpu_torch.utils.sim / imu.preintegration
/ utils.synthetic) with the JAX reference.

The builders draw from different generators (torch.Generator vs
jax.random), so only the deterministic parts of a window are compared:
capacities and census counts, slots and active masks, preintegrated deltas,
relative-pose measurements, extrinsics, intrinsics and the prior.

Tolerance: float32 sample-by-sample integration over 50 samples and a
Cholesky-based whitener, compared at 1e-4 of each array's largest magnitude
(rtol 1e-4); trajectory samples (closed-form chains) at 1e-5.
"""

import dataclasses

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.imu import preintegration as jpre
from beam_slam_tpu.utils import sim as jsim
from beam_slam_tpu.utils import synthetic as jsyn
from beam_slam_tpu_torch.imu import preintegration as tpre
from beam_slam_tpu_torch.utils import sim as tsim
from beam_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

# The __graft_entry__ census.
ENTRY = dict(n_kf=16, kf_dt=0.25, with_vision=True, n_landmarks=64,
             obs_per_lm=4, n_idp=16)


def _close(out, ref, rel, name=""):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, name
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        npt.assert_array_equal(out, ref, err_msg=name)
        return
    scale = max(1.0, float(np.abs(ref).max()))
    npt.assert_allclose(out, ref, atol=rel * scale, rtol=rel, err_msg=name)


def test_trajectory_sample_matches_reference():
    t = np.linspace(0.0, 10.0, 41, dtype=np.float32)
    ref = jsim.AnalyticTrajectory().sample(jnp.asarray(t))
    out = tsim.AnalyticTrajectory(device="cpu").sample(torch.from_numpy(t))
    for f in ref._fields:
        _close(getattr(out, f), getattr(ref, f), 1e-5, f)


def _imu_batch(seed, S=3, N=40):
    rng = np.random.default_rng(seed)
    dt = np.full((S, N), 0.005, np.float32)
    dt[1, -5:] = 0.0                      # trailing samples skipped
    w = (0.5 * rng.standard_normal((S, N, 3))).astype(np.float32)
    a = (rng.standard_normal((S, N, 3)) + [0, 0, 9.8]).astype(np.float32)
    bg = (0.01 * rng.standard_normal(3)).astype(np.float32)
    ba = (0.05 * rng.standard_normal(3)).astype(np.float32)
    return dt, w, a, bg, ba


def test_preintegrate_matches_reference():
    """Three segments at once in the port (batched loop) vs the reference
    vmapped over them; skipped samples by dt = 0 and by the valid mask."""
    dt, w, a, bg, ba = _imu_batch(0)
    valid = np.ones(dt.shape, bool)
    valid[2, 3:7] = False
    noise_j = jpre.PreintNoise.isotropic(1e-4, 1e-3, 1e-6, 1e-5)
    ref = jax.vmap(lambda d, ww, aa, v: jpre.preintegrate(
        d, ww, aa, jnp.asarray(bg), jnp.asarray(ba), noise_j, v))(
            dt, w, a, valid)
    out = tpre.preintegrate(
        torch.from_numpy(dt), torch.from_numpy(w), torch.from_numpy(a),
        torch.from_numpy(bg), torch.from_numpy(ba),
        tpre.PreintNoise.isotropic(1e-4, 1e-3, 1e-6, 1e-5),
        torch.from_numpy(valid))
    for f in dataclasses.fields(ref):
        _close(getattr(out, f.name), getattr(ref, f.name), 1e-4, f.name)


@pytest.mark.parametrize("case", ["regular", "floored", "invalid"])
def test_sqrt_inv_cov_matches_reference(case):
    rng = np.random.default_rng(1)
    M = rng.standard_normal((15, 15)).astype(np.float32)
    cov = (M @ M.T * 1e-3 + 1e-4 * np.eye(15)).astype(np.float32)
    if case == "floored":          # both degeneracy floors apply
        cov = np.zeros((15, 15), np.float32)
    elif case == "invalid":        # not positive definite: fallback weight
        cov[3, 3] = -1.0
    ref = jpre.sqrt_inv_cov(jnp.asarray(cov))
    out = tpre.sqrt_inv_cov(torch.from_numpy(cov))
    _close(out, ref, 1e-4, case)


@pytest.fixture(scope="module")
def windows():
    build = jax.jit(lambda k: jsyn.build_lvio_window(k, **ENTRY)[:2])
    wj, fj = jax.block_until_ready(build(jax.random.PRNGKey(0)))
    wt, ft, losses = tsyn.build_lvio_window(torch.Generator().manual_seed(0),
                                            device="cpu", **ENTRY)
    return wj, fj, wt, ft, losses


# deterministic fields per family (slots/active are checked for all)
DETERMINISTIC = {
    "ImuRelativeFactors": ("dt", "dq", "dp", "dv", "bg_lin", "ba_lin",
                           "dq_dbg", "dp_dbg", "dp_dba", "dv_dbg", "dv_dba",
                           "sqrt_info"),
    "ImuPriorFactors": ("q0", "p0", "v0", "bg0", "ba0", "sqrt_info"),
    "RelativePoseFactors": ("dq", "dp", "sqrt_info"),
    "ReprojectionFactors": ("intr", "sqrt_info"),
    "InverseDepthReprojectionFactors": ("intr", "sqrt_info"),
}


def test_build_lvio_window_deterministic_fields_match_reference(windows):
    wj, fj, wt, ft, losses = windows
    assert losses == (None, None, 1.0, 2.0, 2.0)
    assert [type(f).__name__ for f in ft] == list(DETERMINISTIC)
    for fam_j, fam_t in zip(fj, ft):
        name = type(fam_t).__name__
        _close(fam_t.slots, fam_j.slots, 0.0, f"{name}.slots")
        _close(fam_t.active, fam_j.active, 0.0, f"{name}.active")
        for f in DETERMINISTIC[name]:
            _close(getattr(fam_t, f), getattr(fam_j, f), 1e-4, f"{name}.{f}")
    for f in ("q", "p", "active", "held"):
        _close(getattr(wt.extrinsics, f), getattr(wj.extrinsics, f), 1e-6, f)
    for part in ("imu", "landmarks", "motion"):
        for f in ("active", "held"):
            _close(getattr(getattr(wt, part), f),
                   getattr(getattr(wj, part), f), 0.0, f"{part}.{f}")
    _close(wt.imu.q[0], wj.imu.q[0], 1e-6, "imu.q[0]")  # unperturbed state
    _close(wt.imu.p[0], wj.imu.p[0], 1e-6, "imu.p[0]")


def test_build_lvio_window_census(windows):
    """Census of the __graft_entry__ window: 16 states, 15 IMU and 15
    relative-pose factors, 64·4 reprojection and 16·3 IDP factors."""
    wj, fj, wt, ft, _ = windows
    assert wt.num_dense_dof == wj.num_dense_dof == 16 * 15 + 3 * 6 + 6
    assert wt.landmarks.capacity == wj.landmarks.capacity == 80
    counts_t = [int(f.active.sum()) for f in ft]
    counts_j = [int(np.asarray(f.active).sum()) for f in fj]
    assert counts_t == counts_j == [15, 1, 15, 256, 48]
    # initial states are perturbed draws: close to, not equal to, the
    # reference's (perturb = 0.05)
    gap = (wt.imu.p - torch.tensor(np.asarray(wj.imu.p))).abs().max()
    assert float(gap) < 0.5


def test_build_lvio_batch_shares_topology():
    wb, fb, losses = tsyn.build_lvio_batch(
        torch.Generator().manual_seed(1), 2, n_kf=4, kf_dt=0.25,
        rate_hz=50.0, with_vision=True, n_landmarks=4, obs_per_lm=2, n_idp=2,
        device="cpu")
    assert wb.imu.q.shape == (2, 4, 4) and len(fb) == len(losses) == 5
    for f in fb:
        assert torch.equal(f.slots[0], f.slots[1])
    assert not torch.equal(wb.imu.p[0], wb.imu.p[1])  # fresh draws each
