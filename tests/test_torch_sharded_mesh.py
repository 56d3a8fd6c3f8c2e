"""Parity of the port's sharded refinement step (beam_slam_tpu_torch.
parallel.sharded: the single-card ``Mesh``, ``make_mesh``, ``shard_batch``,
``distributed_refinement_step``) with the JAX package on the CPU: B = 8
LVIO windows of ``n_kf = 4`` (tests/test_multichip.py:24, key 1) solved by
the reference over its 8-device mesh and by the port over 8 shards.
Tolerances: positions within 5e-4 m (the CPU parity tests' bound for a
window solve), final costs within 1e-3 relative or 1e-7 absolute (the
windows converge to ~2e-6, where float32 sums in another order differ by
~1e-8), every window's cost no
higher than where it started, the total the sum of the windows' final
costs; then ``run_submap_refinement(mesh=…)`` against the serial path on
tests/test_torch_refinement.py's map (5e-4 m).

The reference's step over its mesh (~1 min of CPU compile) is recorded in
tests/data/sharded_mesh_jax.json.gz (see tests/test_torch_jax_recording.py);
the slow test_recording_is_the_jax_packages_step runs it again and holds it
to the recording, and ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_sharded_mesh.py record`` rewrites it."""

import sys

import numpy as np
import pytest
import torch

import jax

from beam_slam_tpu.parallel import sharded as jsh
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.utils import synthetic
from beam_slam_tpu_torch.parallel import sharded as tsh
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from test_torch_solver import _bridge

import test_torch_jax_recording as jax_recording

torch.set_num_threads(2)

SOLVE_P, COST_RTOL, COST_ATOL = 5e-4, 1e-3, 1e-7


RECORDING = "sharded_mesh_jax"


def _batch():
    return synthetic.build_lvio_batch(
        jax.random.PRNGKey(1), batch=8, n_kf=4, kf_dt=0.25, rate_hz=50.0)


def jax_step(batch=None):
    """The reference's refinement step over its 8-device mesh: the
    windows' positions and final costs."""
    windows, families, losses = _batch() if batch is None else batch
    out, diags, _ = jsh.distributed_refinement_step(
        jsh.make_mesh(8), windows, families, losses,
        jgn.SolverOptions(max_iterations=3))
    return dict(p=np.asarray(out.imu.p),
                final_cost=np.asarray(diags.final_cost))


@pytest.fixture(scope="module")
def step():
    windows, families, losses = _batch()
    wt, ft = _bridge(windows, families)
    mesh = tsh.make_mesh(8, devices=["cpu"])
    out_t, diags_t, total_t = tsh.distributed_refinement_step(
        mesh, wt, ft, losses, tgn.SolverOptions(max_iterations=3))
    return (jax_recording.load(RECORDING), (out_t, diags_t, total_t),
            (wt, ft, losses))


def test_mesh_layout():
    mesh = tsh.make_mesh(8, devices=["cpu"])
    assert mesh.axis_names == (tsh.SUBMAP_AXIS,)
    assert mesh.shape == {tsh.SUBMAP_AXIS: 8} and mesh.size == 8
    assert mesh.devices == [torch.device("cpu")] * 8
    with pytest.raises(NotImplementedError):
        tsh.make_mesh(2, devices=["cuda:0", "cuda:1"])
    x = tsh.shard_batch(torch.zeros(8, 3), mesh)
    assert x.device == torch.device("cpu")


def test_distributed_refinement_step_matches_reference(step):
    ref, (out_t, diags_t, total_t), _ = step
    np.testing.assert_allclose(out_t.imu.p.numpy(), ref["p"], atol=SOLVE_P)
    np.testing.assert_allclose(diags_t.final_cost.numpy(), ref["final_cost"],
                               rtol=COST_RTOL, atol=COST_ATOL)
    assert np.isfinite(float(total_t))
    assert bool((diags_t.final_cost <= diags_t.initial_cost + 1e-6).all())
    assert float(total_t) == pytest.approx(
        float(diags_t.final_cost.sum()), rel=1e-6)


def test_padding_a_batch_the_shards_do_not_divide(step):
    """Six windows over four shards: padded to eight, the copies dropped;
    the six agree with the unpadded batch solve (positions 1e-6 m, the
    total 1e-4 relative: a batch of eight sums in another order)."""
    *_, (wt, ft, losses) = step
    w6 = wt.map(lambda t: t[:6])
    f6 = tuple(f.map(lambda t: t[:6]) for f in ft)
    opts = tgn.SolverOptions(max_iterations=3)
    out, diags, total = tsh.distributed_refinement_step(
        tsh.make_mesh(4, devices=["cpu"]), w6, f6, losses, opts)
    ref, ref_diags = tsh.solve_batched(w6, f6, losses, opts)
    assert out.imu.p.shape[0] == 6 and diags.final_cost.shape == (6,)
    torch.testing.assert_close(out.imu.p, ref.imu.p, rtol=0, atol=1e-6)
    assert float(total) == pytest.approx(float(ref_diags.final_cost.sum()),
                                         rel=1e-4)


def test_submap_refinement_with_mesh_matches_serial():
    from beam_slam_tpu_torch.global_mapping import refinement as tref
    from test_torch_global_map import map_to_port
    from test_torch_refinement import build_noisy_map, map_poses

    gm_s = map_to_port(build_noisy_map(np.random.default_rng(3)))
    gm_m = map_to_port(build_noisy_map(np.random.default_rng(3)))
    c_s = tref.run_submap_refinement(gm_s, n_outer=1)
    c_m = tref.run_submap_refinement(gm_m, n_outer=1,
                                     mesh=tsh.make_mesh(4, devices=["cpu"]))
    assert c_m == pytest.approx(c_s, rel=COST_RTOL)
    _, kfs_s = map_poses(gm_s)
    _, kfs_m = map_poses(gm_m)
    for (_, pa), (_, pb) in zip(kfs_s, kfs_m):
        np.testing.assert_allclose(pb, pa, atol=SOLVE_P)


@pytest.mark.slow
def test_recording_is_the_jax_packages_step():
    """The reference's step run again equals its recording."""
    jax_recording.assert_same(jax_recording.encode_roundtrip(jax_step()),
                              jax_recording.load(RECORDING))


if __name__ == "__main__" and sys.argv[1:] == ["record"]:
    print(jax_recording.save(RECORDING, jax_step()))
