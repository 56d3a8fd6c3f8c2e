"""Parity of the port's factor families (beam_slam_tpu_torch.core.factors)
and window state (core.window) with the JAX reference.

The window and families are built once by the reference's synthetic builder
at a tiny LVIO census, flattened to numpy and bridged into the port, so both
sides linearize the same inputs. One landmark is deactivated so the block
masks are exercised. The five families the smoother adds (absolute pose,
marginal prior, constant velocity, Unicycle3D, gravity alignment) are held
on a second window and factor set drawn from a numpy seed, with active
motion states and some inactive factors and states.

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
from beam_slam_tpu.core import window as jwin
from beam_slam_tpu.utils import synthetic
from beam_slam_tpu_torch import bridge

torch.set_num_threads(2)

CENSUS = dict(n_kf=6, kf_dt=0.25, with_vision=True, n_landmarks=16,
              obs_per_lm=3, n_idp=4)
NAMES = ["ImuRelativeFactors", "ImuPriorFactors", "RelativePoseFactors",
         "ReprojectionFactors", "InverseDepthReprojectionFactors"]
SMOOTHER_NAMES = ["AbsolutePoseFactors", "MarginalPriorFactors",
                  "ConstantVelocityFactors", "Unicycle3DFactors",
                  "GravityAlignmentFactors"]
ALL_NAMES = NAMES + SMOOTHER_NAMES


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


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q[:, 0] = np.abs(q[:, 0]) + 1.0
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _smoother_problem_np(seed=1, K=6, E=2, M=6, F=5):
    """A window with active motion states and the smoother's five families,
    as numpy dicts drawn from ``seed``: one state and one factor of each
    family inactive, square-root informations of mixed scale."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def vec(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f32)

    def active(n):
        a = np.ones(n, bool)
        a[n // 2] = False
        return a

    state_active = np.ones(K, bool)
    state_active[K - 1] = False
    window = {
        "imu": dict(q=_quats(rng, K), p=vec(K, 3), v=vec(K, 3),
                    bg=vec(K, 3, scale=0.01), ba=vec(K, 3, scale=0.1),
                    active=state_active, held=np.zeros(K, bool)),
        "extrinsics": dict(q=_quats(rng, E), p=vec(E, 3, scale=0.1),
                           active=np.ones(E, bool), held=np.ones(E, bool)),
        "landmarks": dict(pt=vec(1, 3), active=np.zeros(1, bool),
                          held=np.zeros(1, bool)),
        "motion": dict(w=vec(M, 3, scale=0.3), a=vec(M, 3), active=active(M),
                       held=np.zeros(M, bool)),
    }

    def sqrt_info(n, scale):
        return (scale * (np.eye(n) + 0.1 * rng.standard_normal((n, n))))\
            .astype(f32)[None].repeat(F, 0)

    def pairs(width=2):
        return rng.integers(0, K, (F, width)).astype(np.int32)

    Mb = jfc.MARGINAL_MAX_BLOCKS
    uni = pairs()
    fams = {
        "AbsolutePoseFactors": dict(
            slots=pairs(1), active=active(F), q0=_quats(rng, F),
            p0=vec(F, 3), sqrt_info=sqrt_info(6, 10.0)),
        "MarginalPriorFactors": dict(
            slots=rng.integers(0, K, (F, Mb)).astype(np.int32),
            active=active(F), q_lin=_quats(rng, F * Mb).reshape(F, Mb, 4),
            p_lin=vec(F, Mb, 3), v_lin=vec(F, Mb, 3),
            bg_lin=vec(F, Mb, 3, scale=0.01), ba_lin=vec(F, Mb, 3, scale=0.1),
            A=vec(F, Mb * 15, Mb * 15, scale=3.0), b=vec(F, Mb * 15)),
        "ConstantVelocityFactors": dict(
            slots=pairs(), active=active(F),
            dt=rng.uniform(0.05, 0.5, F).astype(f32),
            sqrt_info=sqrt_info(9, 30.0)),
        "Unicycle3DFactors": dict(
            slots=np.stack([uni[:, 0], uni[:, 0], uni[:, 1], uni[:, 1]],
                           axis=1), active=active(F),
            dt=rng.uniform(0.05, 0.5, F).astype(f32),
            sqrt_info=sqrt_info(15, 30.0)),
        "GravityAlignmentFactors": dict(
            slots=pairs(1), active=active(F),
            g_body=(vec(F, 3, scale=0.1) + [0.0, 0.0, -1.0]).astype(f32),
            sqrt_info=sqrt_info(2, 10.0)),
    }
    return window, fams


@pytest.fixture(scope="module")
def smoother_problem():
    w_np, f_np = _smoother_problem_np()
    j = lambda d: {k: jax.numpy.asarray(v) for k, v in d.items()}  # noqa: E731
    wj = jwin.WindowState(
        imu=jwin.ImuStates(**j(w_np["imu"])),
        extrinsics=jwin.Poses(**j(w_np["extrinsics"])),
        landmarks=jwin.Landmarks(**j(w_np["landmarks"])),
        motion=jwin.MotionStates(**j(w_np["motion"])))
    fj = tuple(getattr(jfc, n)(**j(f_np[n])) for n in SMOOTHER_NAMES)
    wt = bridge.window_from_numpy(w_np, "cpu")
    ft = tuple(bridge.family_from_numpy(n, f_np[n], "cpu")
               for n in SMOOTHER_NAMES)
    return wj, fj, wt, ft


def _case(request, name):
    """(JAX window, JAX family, port window, port family) of ``name``."""
    if name in NAMES:
        wj, fj, wt, ft = request.getfixturevalue("problem")
        i = NAMES.index(name)
    else:
        wj, fj, wt, ft = request.getfixturevalue("smoother_problem")
        i = SMOOTHER_NAMES.index(name)
    return wj, fj[i], wt, ft[i]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_linearize_matches_reference(request, name):
    wj, fam_j, wt, fam_t = _case(request, name)
    ref = jax.jit(lambda w, f: f.linearize(w))(wj, fam_j)
    out = fam_t.linearize(wt)
    assert out[0].shape[-1] == type(fam_t).RESIDUAL_DIM
    if name in SMOOTHER_NAMES:  # the masks are exercised
        assert bool(out[3].any()) and not bool(out[3].all())
    for name, a, b in zip(("r", "J", "col", "mask", "lm_slot", "J_lm"),
                          ref, out):
        if a is None:
            assert b is None, name
        else:
            assert tuple(b.shape) == tuple(a.shape), name
            _close(b, a, name)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_residual_only_matches_reference(request, name):
    wj, fam_j, wt, fam_t = _case(request, name)
    ref = jax.jit(lambda w, f: f.residual_only(w))(wj, fam_j)
    _close(fam_t.residual_only(wt), ref)


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
    """Every family of the JAX package is ported (the unary inverse-depth
    one last): it converts, and a name the port does not know raises."""
    fam = jfc.InverseDepthUnaryReprojectionFactors.zeros(2)
    out = bridge.family_from_numpy("InverseDepthUnaryReprojectionFactors",
                                   _flat(fam), "cpu")
    assert type(out).__name__ == "InverseDepthUnaryReprojectionFactors"
    assert out.capacity == 2
    with pytest.raises(KeyError):
        bridge.family_from_numpy("NoSuchFactors", _flat(fam), "cpu")
