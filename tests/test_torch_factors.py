"""Parity of the port's factor families (beam_slam_tpu_torch.core.factors)
and window state (core.window) with the JAX reference.

The window and families are built once by the reference's synthetic builder
at a tiny LVIO census, flattened to numpy and bridged into the port, so both
sides linearize the same inputs. One landmark is deactivated so the block
masks are exercised.

Tolerance: float32 chains through quaternion math and whitening by
sqrt-information matrices with entries up to ~1e4, so r and J are compared
at 2e-5 of each array's largest magnitude (and rtol 1e-4): a few ulps of the
scale, from different operation order. Indices and masks must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import numpy.testing as npt

from beam_slam_tpu.core import factors as jfc
from beam_slam_tpu.utils import synthetic
from beam_slam_tpu_torch import bridge

torch.set_num_threads(2)

CENSUS = dict(n_kf=6, kf_dt=0.25, with_vision=True, n_landmarks=16,
              obs_per_lm=3, n_idp=4)
NAMES = ["ImuRelativeFactors", "ImuPriorFactors", "RelativePoseFactors",
         "ReprojectionFactors", "InverseDepthReprojectionFactors"]


def _flat(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _window_np(w):
    return {k: _flat(getattr(w, k))
            for k in ("imu", "extrinsics", "landmarks", "motion")}


def _close(out, ref, name=""):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        npt.assert_array_equal(out, ref, err_msg=name)
        return
    scale = max(1.0, float(np.abs(ref).max()))
    npt.assert_allclose(out, ref, atol=2e-5 * scale, rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def problem():
    build = jax.jit(lambda k: synthetic.build_lvio_window(k, **CENSUS)[:2])
    wj, fj = jax.block_until_ready(build(jax.random.PRNGKey(0)))
    lm = wj.landmarks
    wj = wj.replace(landmarks=lm.replace(active=lm.active.at[3].set(False)))
    wt = bridge.window_from_numpy(_window_np(wj), "cpu")
    ft = tuple(bridge.family_from_numpy(type(f).__name__, _flat(f), "cpu")
               for f in fj)
    assert [type(f).__name__ for f in ft] == NAMES
    return wj, fj, wt, ft


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_linearize_matches_reference(problem, i):
    wj, fj, wt, ft = problem
    ref = jax.jit(lambda w, f: f.linearize(w))(wj, fj[i])
    out = ft[i].linearize(wt)
    assert out[0].shape[-1] == type(ft[i]).RESIDUAL_DIM
    for name, a, b in zip(("r", "J", "col", "mask", "lm_slot", "J_lm"),
                          ref, out):
        if a is None:
            assert b is None, name
        else:
            assert tuple(b.shape) == tuple(a.shape), name
            _close(b, a, name)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_residual_only_matches_reference(problem, i):
    wj, fj, wt, ft = problem
    ref = jax.jit(lambda w, f: f.residual_only(w))(wj, fj[i])
    _close(ft[i].residual_only(wt), ref)


@pytest.mark.parametrize("i", [3, 4], ids=NAMES[3:])
def test_analytic_jacobian_matches_jacfwd(problem, i):
    """The closed-form Jacobians of the visual families equal forward-mode
    autodiff of their residuals (torch.func.jacfwd over USED_COLS)."""
    _, _, wt, ft = problem
    fam = ft[i]
    assert type(fam).HAS_ANALYTIC
    gathered, _ = fam._gather(wt)
    r_a, J_a = fam.residual_and_jacobian_used(gathered, fam.params())
    r_f, J_f = fam._jacfwd(gathered, fam.params())
    assert J_a.shape == J_f.shape == (fam.capacity, 2,
                                      len(type(fam).USED_COLS))
    _close(r_a, r_f.numpy(), "r")
    _close(J_a, J_f.numpy(), "J")


def test_window_layout_and_retract_match_reference(problem):
    wj, _, wt, _ = problem
    assert wt.num_dense_dof == wj.num_dense_dof
    _close(wt.dense_free_mask(), wj.dense_free_mask())
    rng = np.random.default_rng(0)
    d = (0.1 * rng.standard_normal(wj.num_dense_dof)).astype(np.float32)
    dl = (0.1 * rng.standard_normal(
        (wj.landmarks.capacity, 3))).astype(np.float32)
    ref = jax.jit(lambda w, d, dl: w.retract_dense(d).replace(
        landmarks=w.landmarks.retract(dl)))(wj, d, dl)
    out = wt.retract_dense(torch.from_numpy(d))
    out = out.replace(landmarks=out.landmarks.retract(torch.from_numpy(dl)))
    for k in ("imu", "extrinsics", "landmarks", "motion"):
        for f, a in _flat(getattr(ref, k)).items():
            _close(getattr(getattr(out, k), f), a, f"{k}.{f}")


def test_bridge_rejects_unported_family():
    with pytest.raises(KeyError):
        bridge.family_from_numpy("GravityAlignmentFactors",
                                 _flat(jfc.GravityAlignmentFactors.zeros(2)),
                                 "cpu")
