"""The plain references against the program on the CPU, at small sizes:
the same inputs give the same equations and, after the same LM steps,
the same answers within float32's reach."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import dense
from benchmark.reference import factors as ref_factors
from benchmark.reference import lvio as ref_lvio
from benchmark.reference import window as ref_window
from benchmark.systems import lvio_batch, pose_graph
from benchmark.traffic import lvio_windows

from .conftest import SMALL_LVIO, SMALL_PGO

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CPU = torch.device("cpu")


def _config(name, small):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg["deployment"].update(small)
    return cfg


def test_dense_solve_against_the_library():
    gen = torch.Generator().manual_seed(3)
    A = torch.randn(3, 700, 700, generator=gen, dtype=torch.float64)
    H = A @ A.transpose(-1, -2) + 700 * torch.eye(700, dtype=torch.float64)
    g = torch.randn(3, 700, generator=gen, dtype=torch.float64)
    x, ok = dense.cholesky_solve(H, g, block=256)
    assert bool(ok.all())
    want = torch.linalg.solve(H, g[..., None])[..., 0]
    assert torch.allclose(x, want, rtol=1e-10, atol=1e-12)
    H[1, 300, 300] = -1.0      # not positive definite: NaN, not ok
    x, ok = dense.cholesky_solve(H, g, block=256)
    assert ok.tolist() == [True, False, True]
    assert bool(torch.isnan(x[1]).all()) and bool(torch.isfinite(x[0]).all())


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_pose_graph_reference_agrees_with_the_program(seed):
    s = pose_graph.System(_config("pgo_sphere2500", SMALL_PGO),
                          {"lm_steps": 20}, seed, CPU)
    answer = s.solve()
    gaps = s.compare([answer], s.reference())
    assert gaps["excess_cost_rel"] < 1e-5, gaps
    assert gaps["rot_gap_rad"] < 1e-3, gaps
    # the reference in float32 lands as near
    f32 = s.compare([s.reference(torch.float32)], s.reference())
    assert f32["excess_cost_rel"] < 1e-5, f32


def _program_window(window, families):
    from beam_slam_tpu_torch.core import factors as fc
    from beam_slam_tpu_torch.core import window as win
    return lvio_batch._build(win, fc, window, families)


def test_lvio_equations_agree_with_the_programs():
    """The reference's normal equations, at the same state in float32,
    equal the program's assembly."""
    from beam_slam_tpu_torch.solver import gauss_newton as gn
    d = dict(_config("lvio_window", SMALL_LVIO)["deployment"])
    window, families, losses = lvio_windows.generate(d, 2, 11, CPU)
    w_p, f_p = _program_window(window, families)
    w_r, f_r = lvio_batch._build(ref_window, ref_factors, window, families)
    got = ref_lvio.assemble(w_r, f_r, losses)
    want = gn.assemble_normal_equations(w_p, f_p, losses)
    for a, b, name in zip(got, want, ("H", "g", "H_ll", "g_l", "W", "cost")):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("seed", [21, 2 ** 32 + 5])
def test_lvio_reference_agrees_with_the_program(seed):
    mix = {"batch": 3, "lm_steps": 10}
    s = lvio_batch.System(_config("lvio_window", SMALL_LVIO), mix, seed, CPU)
    s.warm_up()
    answer = s.solve()
    gaps = s.compare([answer], s.reference())
    assert gaps["excess_cost_rel"] < 1e-4, gaps
    assert gaps["rot_gap_rad"] < 1e-3, gaps
