"""The traffic generators: the sphere2500 graph's and the LVIO census's
counts, and what the seed changes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.traffic import lvio_windows, pose_graph
from benchmark.traffic import quat_np as qn

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SEED = 2 ** 31 + 12345   # the driver's seeds pass 32 signed bits


def _deployment(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["deployment"]


def test_sphere2500_counts_and_layout():
    d = _deployment("pgo_sphere2500")
    prob = pose_graph.generate(d, SEED, "cpu")
    assert prob["q"].shape == (2500, 4) and prob["p"].shape == (2500, 3)
    assert prob["i"].shape == (4949,)
    odo, loop = pose_graph.edges(d["rings"], d["poses_per_ring"])
    assert (len(odo), len(loop)) == (2499, 2450)
    assert (len(odo), len(loop)) == (d["odometry_edges"], d["loop_edges"])
    assert np.array_equal(odo[:, 1] - odo[:, 0], np.ones(2499))
    # each ring edge joins a pose to the one beside it in the next ring:
    # the next ring, 50 poses on in the chain
    assert np.array_equal(loop[:, 1] - loop[:, 0], np.full(2450, 50))
    q, p = pose_graph.sphere(d["rings"], d["poses_per_ring"], d["radius"])
    r = np.linalg.norm(p, axis=1)
    assert np.allclose(r, d["radius"])
    assert np.array_equal(loop[:, 0] % 50, loop[:, 1] % 50)
    # straight on along the meridian: the same heading, the next ring down
    # (create_sphere starts at the pole where z = +radius)
    up = qn.rotate(q, np.broadcast_to([0.0, 1.0, 0.0], p.shape))
    assert np.allclose(up[loop[:, 0]], up[loop[:, 1]], atol=1e-9)
    assert np.all(p[loop[:, 1], 2] < p[loop[:, 0], 2])
    assert not bool(prob["free"][0]) and bool(prob["free"][1:].all())


def test_sphere_seed_changes_the_noise_not_the_graph():
    d = dict(_deployment("pgo_sphere2500"), rings=4, poses_per_ring=5)
    a = pose_graph.generate(d, SEED, "cpu")
    b = pose_graph.generate(d, SEED, "cpu")
    c = pose_graph.generate(d, SEED + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape == c[k].shape
    assert torch.equal(a["i"], c["i"]) and torch.equal(a["j"], c["j"])
    assert not torch.equal(a["dp"], c["dp"])


def test_lvio_census():
    d = _deployment("lvio_window")
    assert lvio_windows.census(d) == dict(
        states=40, imu=39, lidar=39, reprojection=2048, inverse_depth=448,
        landmarks=320)
    window, families, losses = lvio_windows.generate(d, 2, SEED, "cpu")
    active = {name: int(leaves["active"][0].sum())
              for name, leaves in families}
    assert active == dict(ImuRelativeFactors=39, ImuPriorFactors=1,
                          RelativePoseFactors=39, ReprojectionFactors=2048,
                          InverseDepthReprojectionFactors=448)
    assert int(window["landmarks"]["active"][0].sum()) == 320
    assert window["imu"]["q"].shape == (2, 40, 4)
    assert losses == (None, None, 1.0, 2.0, 2.0)
    # every observation in front of its camera, every inverse depth > 0
    assert bool((window["landmarks"]["pt"][:, 256:, 0] > 0).all())


def test_lvio_seed_changes_the_draws_not_the_shapes():
    d = dict(_deployment("lvio_window"), n_kf=8, n_landmarks=16,
             obs_per_lm=3, n_idp=4)
    a = lvio_windows.generate(d, 3, SEED, "cpu")
    b = lvio_windows.generate(d, 3, SEED, "cpu")
    c = lvio_windows.generate(d, 3, SEED + 7, "cpu")
    for (wa, fa, _), (wb, fb, _) in ((a, b),):
        for blk in wa:
            for k in wa[blk]:
                assert torch.equal(wa[blk][k], wb[blk][k]), (blk, k)
    for blk in a[0]:
        for k in a[0][blk]:
            assert a[0][blk][k].shape == c[0][blk][k].shape
    assert not torch.equal(a[0]["imu"]["p"], c[0]["imu"]["p"])
    # the windows of one batch differ, their topology does not
    assert not torch.equal(a[0]["imu"]["p"][0], a[0]["imu"]["p"][1])
    for _, leaves in a[1]:
        assert bool((leaves["slots"] == leaves["slots"][:1]).all())


@pytest.mark.parametrize("segment", [0, 17, 38])
def test_lvio_preintegration_matches_the_programs(segment):
    """The traffic's own copy of the IMU arithmetic agrees with the
    program's host preintegration on the same samples."""
    from beam_slam_tpu_torch.imu import preintegration as pre
    from beam_slam_tpu_torch.utils import sim
    d = _deployment("lvio_window")
    (_, _, _), mine = lvio_windows._shared(d)
    h = d["kf_dt"] / round(d["kf_dt"] * d["rate_hz"])
    t = segment * d["kf_dt"] + (np.arange(50) + 0.5) * h
    traj = sim.AnalyticTrajectory(dtype=torch.float64, device="cpu")
    s = traj.sample(torch.tensor(t))
    noise = pre.PreintNoise.isotropic(*lvio_windows.IMU_SIGMA,
                                      dtype=torch.float64)
    want = pre.preintegrate_np(np.full(50, h), s.w_body.numpy(),
                               s.a_body.numpy(), np.zeros(3), np.zeros(3),
                               noise)
    names = ("t", "q", "p", "v", "dq_dbg", "dp_dbg", "dp_dba", "dv_dbg",
             "dv_dba", "sqrt_inv_cov")
    for name, got in zip(names, mine):
        ref = np.asarray(getattr(want, name), np.float64)
        assert np.allclose(got[segment], ref, rtol=1e-5,
                           atol=1e-6 * np.abs(ref).max()), name
