"""Parity of the port's unary inverse-depth reprojection family
(beam_slam_tpu_torch.core.factors.InverseDepthUnaryReprojectionFactors)
with the JAX package on the CPU.

Seeded factors (numpy seed 5: measurement poses, extrinsics, fixed anchor
camera poses, bearings, ρ, intrinsics, whitening) through both families:
residual and closed-form Jacobian over USED_COLS within 1e-5 relative (to
the largest entry); the port's closed form against ``torch.func.jacfwd`` of
its own residual (1e-4 relative); then the port's mirror of
tests/test_idp.py::test_unary_idp_reprojection_converges (the test's
criteria, final cost < 1e-6 and |ρ − ρ_gt| < 1e-3, and ρ within 1e-5 of
the reference's solve of the same problem)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import factors as jfc
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.core import factors as tfc
from beam_slam_tpu_torch.solver import gauss_newton as tgn

torch.set_num_threads(2)

F = 24
RTOL = 1e-5


def _unit_quats(rng, n, scale):
    w = rng.standard_normal((n, 3)) * scale
    th = np.linalg.norm(w, axis=1, keepdims=True)
    return np.concatenate([np.cos(th / 2), np.sin(th / 2) * w / th],
                          1).astype(np.float32)


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(5)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    states = dict(
        q_m=_unit_quats(rng, F, 0.3), p_m=f32(rng.normal(0, 0.5, (F, 3))),
        q_bc=_unit_quats(rng, F, 0.1), p_bc=f32(rng.normal(0, 0.1, (F, 3))),
        # ρ: most live, a few below the 1e-4 floor (zero ρ column)
        rho=f32(np.where(np.arange(F) % 8 == 7, 5e-5,
                         rng.uniform(0.1, 0.5, F))))
    params = dict(
        q_anchor=_unit_quats(rng, F, 0.2),
        p_anchor=f32(rng.normal(0, 0.3, (F, 3))),
        bearing=f32(rng.uniform(-0.3, 0.3, (F, 2))),
        pixel=f32(rng.uniform(100, 500, (F, 2))),
        intr=f32(np.tile([400.0, 410.0, 320.0, 240.0], (F, 1))),
        sqrt_info=f32(np.eye(2)[None] * rng.uniform(0.5, 2.0, (F, 1, 1))))
    return states, params


def _blocks(states, lib):
    """The family's (IMU, extrinsic, landmark) block states; ρ in the
    landmark's component 0. ``lib``: jnp or torch."""
    rho = states["rho"]
    z3 = lib.zeros_like(states["p_m"])
    lm = lib.stack([rho, rho * 0, rho * 0], -1)
    return ((states["q_m"], states["p_m"], z3, z3, z3),
            (states["q_bc"], states["p_bc"]), (lm,))


def _jax_side(states, params):
    fam = jfc.InverseDepthUnaryReprojectionFactors.zeros(F)
    fam = fam.replace(**{k: jnp.asarray(v) for k, v in params.items()})
    s = {k: jnp.asarray(v) for k, v in states.items()}
    blocks = _blocks(s, jnp)
    p = fam.params()
    return jax.vmap(fam.residual_and_jacobian_used)(blocks, p)


def _port_family(params):
    fields = dict(slots=np.zeros((F, 3), np.int64),
                  active=np.ones(F, bool), **params)
    return bridge.idp_unary_from_numpy(fields, "cpu")


def test_residual_and_jacobian_match_reference(factors):
    states, params = factors
    r_j, J_j = (np.asarray(a) for a in _jax_side(states, params))
    fam = _port_family(params)
    s = {k: torch.tensor(v) for k, v in states.items()}
    r_t, J_t = fam.residual_and_jacobian_used(_blocks(s, torch),
                                              fam.params())
    assert J_t.shape == (F, 2, len(tfc.InverseDepthUnaryReprojectionFactors
                                   .USED_COLS))
    np.testing.assert_allclose(r_t.numpy(), r_j,
                               atol=RTOL * np.abs(r_j).max())
    np.testing.assert_allclose(J_t.numpy(), J_j,
                               atol=RTOL * np.abs(J_j).max())
    # the floored ρ's column is exactly zero, as in the reference
    assert not J_t[7::8, :, -1].any()
    # the plain residual (quaternion chain) agrees with the analytic pass's
    # (rotation matrices), relative to the largest entry
    torch.testing.assert_close(fam.residual(_blocks(s, torch), fam.params()),
                               r_t, rtol=0,
                               atol=RTOL * float(r_t.abs().max()))


def test_analytic_jacobian_matches_jacfwd(factors):
    states, params = factors
    fam = _port_family(params)
    s = {k: torch.tensor(v, dtype=torch.float64) for k, v in states.items()}
    p64 = tuple(t.double() for t in fam.params())
    blocks = _blocks(s, torch)
    _, J_a = fam.residual_and_jacobian_used(blocks, p64)
    _, J_f = fam._jacfwd(blocks, p64)
    live = np.arange(F) % 8 != 7      # the clamp's kink: ρ at the floor
    np.testing.assert_allclose(J_a.numpy()[live], J_f.numpy()[live],
                               atol=1e-4 * float(J_f.abs().max()))


def test_family_metadata_matches_reference():
    j, t = jfc.InverseDepthUnaryReprojectionFactors, \
        tfc.InverseDepthUnaryReprojectionFactors
    assert t.BLOCKS == j.BLOCKS and t.USED_COLS == j.USED_COLS
    assert t.HAS_ANALYTIC is True and t.RESIDUAL_DIM == j.RESIDUAL_DIM
    assert tfc.FAMILIES["InverseDepthUnaryReprojectionFactors"] is t
    z = t.zeros(3, device="cpu")
    assert z.capacity == 3 and z.slots.shape == (3, 3)


def test_unary_idp_reprojection_converges(monkeypatch):
    """The mirror of tests/test_idp.py::test_unary_idp_reprojection_converges
    (chip_smoke.unary_idp_problem builds the same problem), against the
    reference's solve of it."""
    import chip_smoke
    from test_idp import test_unary_idp_reprojection_converges as ref_test

    window, fams, losses, rho_gt = chip_smoke.unary_idp_problem("cpu")
    out, diag = tgn.solve(window, fams, losses,
                          tgn.SolverOptions(max_iterations=15))
    assert float(diag.final_cost) < 1e-6
    rho = float(out.landmarks.pt[0, 0])
    assert abs(rho - rho_gt) < 1e-3, rho

    captured = {}
    real_solve = jgn.solve

    def solve(*a, **k):
        captured["out"] = real_solve(*a, **k)
        return captured["out"]
    monkeypatch.setattr(jgn, "solve", solve)
    ref_test()
    rho_ref = float(captured["out"][0].landmarks.pt[0, 0])
    assert abs(rho - rho_ref) < 1e-5, (rho, rho_ref)
