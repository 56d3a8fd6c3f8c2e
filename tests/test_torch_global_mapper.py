"""Parity of the port's GlobalMapper (beam_slam_tpu_torch.models.
global_mapper) with the JAX package on the CPU: the drifting loop of
tests/test_global_mapping.py::test_loop_closure_corrects_drift and the
reloc request of tests/test_reloc_request.py, in both packages.

Both mappers get the same chunks (the 16 × 504 synthetic scene seen from
the true poses, features extracted by the JAX package; the odometry poses
drift by up to 0.4 m) and a small SmootherConfig (8 states, LM ≤ 15 steps),
so that the JAX compile stays short. The reference runs first and records
its candidates, each loop registration, and every submap pose after every
chunk. The port then runs with its own registrations held against the
reference's (2e-3 m / 2e-3 rad, ``successful`` equal) and its graph fed the
reference's loop factors, as tests/test_torch_vio_session.py feeds lidar
factors, so that the comparison of its submap poses after every solve
(2e-3 m / 2e-3 rad) holds the graph alone.
"""

import numpy as np
import pytest
import torch

from beam_slam_tpu.global_mapping import global_map as jgmap
from beam_slam_tpu.global_mapping import reloc as jreloc
from beam_slam_tpu.models import global_mapper as jgm
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu_torch.global_mapping import global_map as tgmap
from beam_slam_tpu_torch.global_mapping import reloc as treloc
from beam_slam_tpu_torch.models import global_mapper as tgm
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from test_torch_global_map import (IDENTITY, REG_P, REG_R, assert_pose_close,
                                   chunks, features_j, to_port)

torch.set_num_threads(2)

SMALL = dict(lag_duration=1e9, max_states=8, max_rel_pose_factors=16,
             max_abs_pose_factors=2, max_imu_factors=1, max_prior_factors=1,
             max_landmarks=1, max_reprojection_factors=1,
             max_gravity_factors=1, max_motion_factors=1,
             max_unicycle_factors=1, max_idp_factors=1,
             max_marginal_factors=1)
GRAPH_P, GRAPH_R = 2e-3, 2e-3      # submap poses after every solve
XS = [0.0, 2.0, 4.0, 6.0, 6.0, 4.0, 2.0, 0.0]
YS = [0.0, 0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 2.0]


class _Record:
    """Wraps the reference's refinement and search: every call recorded."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def refine(self, match, query):
        res = self.inner.refine(match, query)
        self.calls.append((match.stamp, query.stamp, res))
        return res

    def find(self, submaps, query_idx, max_candidates=3):
        out = self.inner.find(submaps, query_idx, max_candidates)
        self.calls.append((query_idx, out))
        return out


class _Replay:
    """The port's refinement held against the reference's recorded result
    for the same pair, which it then returns: the port's graph gets the
    reference's loop factors."""

    def __init__(self, inner, recorded):
        self.inner, self.recorded, self.checked = inner, list(recorded), 0

    def refine(self, match, query):
        got = self.inner.refine(match, query)
        ms, qs, want = self.recorded.pop(0)
        assert (match.stamp, query.stamp) == (ms, qs)
        assert got.successful == want.successful, (ms, qs)
        assert_pose_close(got.dq, got.dp, want.dq, want.dp, REG_P, REG_R,
                          (ms, qs))
        self.checked += 1
        return treloc.RelocResult(want.successful, np.asarray(want.dq),
                                  np.asarray(want.dp),
                                  np.asarray(want.information))


def _mapper(mod, gmap, sm_mod, gn_mod, **kw):
    params = gmap.GlobalMapParams(submap_size_m=3.0, loop_closure=True,
                                  candidate_search="EUCDIST",
                                  max_candidates=1)
    cfg = sm_mod.SmootherConfig(**SMALL,
                                solver=gn_mod.SolverOptions(max_iterations=15))
    return mod.GlobalMapper(params, smoother_config=cfg, **kw)


def _poses(m):
    return [(sm.q.copy(), sm.p.copy()) for sm in m.map.submaps]


def _drive(m, side):
    """The reference test's drifting out-and-back chunks, then its flush
    (a loop closure on the last submap, and a solve), then a reloc request
    from a pose 0.3 / 0.4 m off x = 1. Returns the submap poses after every
    chunk and after the flush, the loop counts and the reloc answer."""
    Txn = jsm.Transaction if side == 0 else tsm.Transaction
    drift = np.linspace(0, 0.4, len(XS))
    after = []
    for i, (x, y) in enumerate(zip(XS, YS)):
        p_true = np.array([x, y, 0.0], np.float32)
        c = chunks(IDENTITY, p_true, float(i))[side]
        m.process_slam_chunk(c._replace(
            p_wb=p_true + np.array([0.0, drift[i], 0.0], np.float32)))
        after.append(_poses(m))
    n_sub = len(m.map.submaps)
    txn = Txn(stamp=100.0)
    found = m.map.run_loop_closure(n_sub - 1, txn)
    if found:
        m.smoother.send_transaction(txn)
        m.optimize()
    after.append(_poses(m))
    fj = features_j(IDENTITY, [1.0, 0.0, 0.0])
    reloc = m.process_reloc_request(
        99.0, fj if side == 0 else to_port(fj), IDENTITY,
        np.array([1.3, 0.4, 0.0], np.float32))
    return dict(after=after, loops=m.n_loop_closures, found=found,
                reloc=reloc)


@pytest.fixture(scope="module")
def runs():
    mj = _mapper(jgm, jgmap, jsm, jgn)
    mj.map.candidate_search = _Record(jreloc.EuclideanCandidateSearch(
        max_distance_m=6.0, skip_recent=1))
    mj.map.refinement = _Record(mj.map.refinement)
    out_j = _drive(mj, 0)
    mt = _mapper(tgm, tgmap, tsm, tgn, device="cpu")
    mt.map.candidate_search = _Record(treloc.EuclideanCandidateSearch(
        max_distance_m=6.0, skip_recent=1))
    mt.map.refinement = _Replay(mt.map.refinement, mj.map.refinement.calls)
    out_t = _drive(mt, 1)
    return dict(mj=mj, mt=mt, j=out_j, t=out_t)


def test_loop_closure_corrects_drift_in_both(runs):
    """The reference test's criteria, on both sides."""
    for side in ("j", "t"):
        out, m = runs[side], runs["m" + side]
        assert len(m.map.submaps) >= 3
        assert out["loops"] + out["found"] >= 1
        last = m.map.submaps[-1]
        y_err = abs(last.p[1] - YS[-2 if last.stamp == 6.0 else -1])
        assert y_err < 0.25, (side, last.p, y_err)


def test_same_submaps_candidates_and_registrations(runs):
    mj, mt = runs["mj"], runs["mt"]
    assert [s.stamp for s in mt.map.submaps] == \
        [s.stamp for s in mj.map.submaps]
    assert [len(s.lidar_keyframes) for s in mt.map.submaps] == \
        [len(s.lidar_keyframes) for s in mj.map.submaps]
    assert mt.map.candidate_search.calls == mj.map.candidate_search.calls
    assert mt.map.refinement.checked == len(mj.map.refinement.calls) >= 2
    assert not mt.map.refinement.recorded
    assert runs["t"]["loops"] == runs["j"]["loops"]
    assert runs["t"]["found"] == runs["j"]["found"]


def test_submap_poses_after_every_solve(runs):
    for k, (pt, pj) in enumerate(zip(runs["t"]["after"],
                                     runs["j"]["after"])):
        assert len(pt) == len(pj), k
        for s, ((qa, pa), (qb, pb)) in enumerate(zip(pt, pj)):
            assert_pose_close(qa, pa, qb, pb, GRAPH_P, GRAPH_R, (k, s))


def test_reloc_request_matches_reference(runs):
    (qt, pt), (qj, pj) = runs["t"]["reloc"], runs["j"]["reloc"]
    assert_pose_close(qt, pt, qj, pj, REG_P, REG_R)
    assert np.linalg.norm(pt - np.array([1.0, 0, 0])) < 0.1


def test_reloc_request_empty_map():
    m = _mapper(tgm, tgmap, tsm, tgn, device="cpu")
    fc = to_port(features_j(IDENTITY, [0.0, 0.0, 0.0]))
    assert m.process_reloc_request(0.0, fc, IDENTITY, np.zeros(3)) is None
    assert not m.map.submaps


def test_trajectory_and_save_load(runs, tmp_path):
    """The mapper's trajectory and its saved map, loaded by both packages."""
    mt = runs["mt"]
    traj = mt.trajectory_world()
    assert [t for t, _, _ in traj] == [float(i) for i in range(len(XS))]
    mt.save(str(tmp_path / "map"))
    for gm in (tgmap.GlobalMap.load(str(tmp_path / "map"), device="cpu"),
               jgmap.GlobalMap.load(str(tmp_path / "map"))):
        assert len(gm.submaps) == len(mt.map.submaps)
        for a, b in zip(gm.submaps, mt.map.submaps):
            np.testing.assert_array_equal(a.p, b.p)


def test_local_mapper_feeds_global_mapper():
    """``LocalMapper(cfg, chunk_cb=gm.process_slam_chunk)``: a keyframe
    that leaves the LIO mapper's window reaches the global map as a
    SlamChunk of the port's lidar odometry."""
    import os

    from beam_slam_tpu_torch.pipeline.config import LocalMapperConfig
    from beam_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    gm = _mapper(tgm, tgmap, tsm, tgn, device="cpu")
    lm = LocalMapper(LocalMapperConfig.from_yaml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "lio.yaml")), chunk_cb=gm.process_slam_chunk,
        device="cpu")
    lo = lm.lo
    lo.initialized = True
    p = np.array([0.5, 0.2, 0.0], np.float32)
    lo._kf_features[0.5] = to_port(features_j(IDENTITY, p))
    lo._kf_pose[0.5] = (IDENTITY, p)
    lo._on_graph_update(lm.smoother)   # 0.5 is not in the window: published
    assert len(gm.map.submaps) == 1
    kfs = gm.map.submaps[0].lidar_keyframes
    assert [k.stamp for k in kfs] == [0.5]
    np.testing.assert_array_equal(gm.map.submaps[0].p, p)
    assert gm.smoother.current_stamps() == [0.5]
