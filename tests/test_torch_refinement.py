"""Parity of the port's submap refinement (beam_slam_tpu_torch.
global_mapping.refinement, through parallel.sharded) with the JAX package
on the CPU, and the helpers the other refinement test files share.

The map: two submaps of 3 and 2 keyframes (the keyframe counts differ, so
submap refinement takes the per-window batched solve), their keyframe
poses perturbed from the truth by seeded noise (numpy seed 0) while the
scans are the 16 × 504 synthetic scene seen from the true poses
(tests/test_refinement.py's build_noisy_map). The JAX package builds it,
the bridge carries it across, and each of the four stages runs in both
packages from the same map (the port's copy is re-synced from the
reference's before each stage, so each stage is held alone). This file
holds submap refinement and the batched solves; tests/test_torch_
refinement_align.py the alignment and the CLI, tests/test_torch_
refinement_graph.py the pose-graph and batch stages, and tests/test_torch_
sharded.py the batched solve on a batch whose slots differ.

Tolerances (each stated at its assert): the submap problem's flags equal
and its priors within 2e-3 m / 2e-3 rad (registrations); the batched
solves within 5e-4 m (the CPU parity tests' bound for a window solve);
stage poses within 2e-3 m / 2e-3 rad and stats equal (counts) or within
1e-6 (the summed final cost, ~1e-17 here: every prior is met).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from beam_slam_tpu.global_mapping import global_map as jgmap
from beam_slam_tpu.global_mapping import refinement as jref
from beam_slam_tpu.global_mapping import submap as jsub
from beam_slam_tpu.models import global_mapper as jgm
from beam_slam_tpu.parallel import sharded as jsharded
from beam_slam_tpu.solver import gauss_newton as jgn
from beam_slam_tpu.solver import smoother as jsm
from beam_slam_tpu_torch import bridge
from beam_slam_tpu_torch.global_mapping import refinement as tref
from beam_slam_tpu_torch.models import global_mapper as tgm
from beam_slam_tpu_torch.parallel import sharded as tsharded
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from test_torch_global_map import (CONFIGS, IDENTITY, REG_P, REG_R,
                                   assert_pose_close, features_j, map_to_port)

torch.set_num_threads(2)

STAGE_P, STAGE_R = 2e-3, 2e-3     # keyframe and submap poses after a stage
SOLVE_P = 5e-4                    # batched window solves, metres
COST_ATOL = 1e-6                  # the summed refinement cost
KF_COUNTS = (3, 2)
PARTS = ("imu", "extrinsics", "landmarks", "motion")


def build_noisy_map(rng, counts=KF_COUNTS, noise=0.08):
    """tests/test_refinement.py's build_noisy_map with per-submap keyframe
    counts: scans at the true poses, keyframe poses perturbed."""
    gm = jgmap.GlobalMap(jgmap.GlobalMapParams(submap_size_m=100.0,
                                               loop_closure=False))
    for s, n in enumerate(counts):
        origin = np.array([2.0 * s, 0.0, 0.0], np.float32)
        sm = jsub.Submap(float(s * 10), IDENTITY, origin)
        for k in range(n):
            p_true = origin + np.array([0.5 * k, 0.3 * (k % 2), 0.0],
                                       np.float32)
            fc = features_j(IDENTITY, p_true)
            p_noisy = p_true + rng.standard_normal(3).astype(
                np.float32) * noise
            sm.add_lidar_keyframe(s * 10 + k, IDENTITY, p_noisy, fc)
        gm.submaps.append(sm)
    return gm


def map_poses(gm):
    return ([(s.q.copy(), s.p.copy()) for s in gm.submaps],
            [(k.q.copy(), k.p.copy()) for s in gm.submaps
             for k in s.lidar_keyframes])


class _Wrap:
    """Record a module function's calls (args and result) while a stage
    runs."""

    def __init__(self, mod, name):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*a, **k):
            out = self.fn(*a, **k)
            self.calls.append((a, out))
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


# The pose graphs of the pose-graph and batch stages: the batch stage's
# smoother at max_keyframes=16, and the pose-graph stage's GlobalMapper
# given the same capacities and solver options, so that the JAX package
# compiles one LM loop for both.
GRAPH_KF = 16
GRAPH_CFG = dict(lag_duration=1e12, max_states=GRAPH_KF,
                 max_rel_pose_factors=4 * GRAPH_KF, max_abs_pose_factors=4,
                 max_imu_factors=2, max_prior_factors=2, max_landmarks=1,
                 max_reprojection_factors=1, max_idp_factors=1)


class SmallGraph:
    """The GlobalMapper of the pose-graph stage with GRAPH_CFG."""

    def __init__(self, mod, sm_mod, gn_mod):
        self.mod, self.cls = mod, mod.GlobalMapper
        cfg = sm_mod.SmootherConfig(
            **GRAPH_CFG, solver=gn_mod.SolverOptions(max_iterations=20))
        cls = self.cls
        self.small = lambda params, global_map=None, **kw: cls(
            params, smoother_config=cfg, global_map=global_map, **kw)

    def __enter__(self):
        self.mod.GlobalMapper = self.small

    def __exit__(self, *exc):
        self.mod.GlobalMapper = self.cls


def run_stage(name, gm, side):
    ref = jref if side == "j" else tref
    if name == "refinement":
        return ref.run_submap_refinement(gm)
    if name == "alignment":
        return ref.run_submap_alignment(gm)
    if name == "pgo":
        with (SmallGraph(jgm, jsm, jgn) if side == "j"
              else SmallGraph(tgm, tsm, tgn)):
            return ref.run_pose_graph_optimization(gm)
    params = ref.BatchOptimizationParams(max_keyframes=GRAPH_KF)
    return ref.run_batch_optimization(gm, params)


def run_stages(names, wrap_refinement=False):
    """Each stage in both packages from the same map (the port's copy
    re-synced before each); the poses after each."""
    gm_j = build_noisy_map(np.random.default_rng(0))
    out = dict(before=map_poses(gm_j))
    for name in names:
        gm_t = map_to_port(gm_j)
        if name == "refinement" and wrap_refinement:
            with _Wrap(jref, "_submap_problem") as pj, \
                    _Wrap(tref, "_submap_problem") as pt, \
                    _Wrap(jsharded, "solve_batched") as sj, \
                    _Wrap(tsharded, "solve_batched") as st:
                stats = (run_stage(name, gm_j, "j"),
                         run_stage(name, gm_t, "t"))
            out["problems"] = (pj.calls, pt.calls)
            out["solves"] = (sj.calls, st.calls)
        else:
            stats = (run_stage(name, gm_j, "j"), run_stage(name, gm_t, "t"))
        out[name] = dict(stats=stats, poses=(map_poses(gm_j),
                                             map_poses(gm_t)))
    return out


def assert_stage(st, name):
    sj, stt = st["stats"]
    if name == "refinement":
        assert abs(stt - sj) <= COST_ATOL, (stt, sj)
    else:
        assert stt == sj, (stt, sj)
    (subs_j, kfs_j), (subs_t, kfs_t) = st["poses"]
    for (qa, pa), (qb, pb) in zip(subs_t + kfs_t, subs_j + kfs_j):
        assert_pose_close(qa, pa, qb, pb, STAGE_P, STAGE_R, name)


STAGES = ("refinement",)


@pytest.fixture(scope="module")
def stages():
    """Submap refinement in both packages; its submap problems and batched
    solves recorded."""
    return run_stages(STAGES, wrap_refinement=True)


def test_submap_problem_matches_reference(stages):
    pj, pt = stages["problems"]
    assert len(pt) == len(pj) == 2 * len(KF_COUNTS)   # two outer rounds
    for r, ((_, (wj, (fj,))), (_, (wt, (ft,)))) in enumerate(zip(pj, pt)):
        for name in ("active", "held"):
            np.testing.assert_array_equal(getattr(wt.imu, name).numpy(),
                                          np.asarray(getattr(wj.imu, name)))
        # the first round starts from the same poses; the second from each
        # package's first solve
        np.testing.assert_allclose(wt.imu.p.numpy(), np.asarray(wj.imu.p),
                                   atol=0 if r < len(KF_COUNTS) else SOLVE_P)
        np.testing.assert_array_equal(ft.active.numpy(),
                                      np.asarray(fj.active))
        np.testing.assert_array_equal(ft.slots.numpy(), np.asarray(fj.slots))
        # which keyframes converged: the registration weight or the prior's
        np.testing.assert_array_equal(ft.sqrt_info.numpy(),
                                      np.asarray(fj.sqrt_info))
        for k in np.flatnonzero(np.asarray(fj.active)):
            assert_pose_close(ft.q0[k].numpy(), ft.p0[k].numpy(),
                              np.asarray(fj.q0[k]), np.asarray(fj.p0[k]),
                              REG_P, REG_R, k)


def test_submap_refinement_batch_solve_matches_reference(stages):
    """The refinement's own batch (keyframe counts 3 and 2: ``active``
    differs) through the per-window solve in both packages, on the same
    inputs; and through the port's shared-slot path, bit for bit."""
    (aj, _), = stages["solves"][0][:1]
    wj, fj, losses, opts = aj
    wt = bridge.window_from_numpy(
        {k: _flat(getattr(wj, k)) for k in PARTS}, "cpu")
    ft = tuple(bridge.family_from_numpy(type(f).__name__, _flat(f), "cpu")
               for f in fj)
    assert len(stages["solves"][1]) == len(stages["solves"][0]) == 2
    out_j, d_j = jsharded.solve_batched(wj, fj, losses, opts)
    out_t, d_t = tsharded.solve_batched(wt, ft, losses,
                                        _port_options(opts))
    assert np.abs(out_t.imu.p.numpy() - np.asarray(out_j.imu.p)).max() \
        <= SOLVE_P
    np.testing.assert_allclose(d_t.final_cost.numpy(),
                               np.asarray(d_j.final_cost), rtol=1e-3,
                               atol=1e-6)
    # the slots are shared (arange(K) in every submap): the shared-slot
    # assembly reads the per-window ``active`` through the mask
    out_s, d_s = tgn.lm_loop(
        wt, lambda w: tgn.assemble_normal_equations(w, ft, losses),
        opts.max_iterations, _port_options(opts))
    for a, b in ((out_s.imu.q, out_t.imu.q), (out_s.imu.p, out_t.imu.p),
                 (d_s.final_cost, d_t.final_cost)):
        assert torch.equal(a, b)


def _port_options(opts):
    return tgn.SolverOptions(**{k: v for k, v in opts._asdict().items()
                                if k in tgn.SolverOptions._fields})


def _flat(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_reference(stages, name):
    assert_stage(stages[name], name)


def test_refinement_lowers_keyframe_error(stages):
    """tests/test_refinement.py's criterion on the port's refined map, on
    the submap of 3 keyframes: the demeaned per-keyframe error falls. (In a
    submap of 2, each keyframe's leave-one-out map is the other's scan at
    its noisy pose, and the error does not fall — in both packages, as the
    stage comparison shows.)"""
    n = KF_COUNTS[0]
    truth = np.array([[0.5 * k, 0.3 * (k % 2), 0.0] for k in range(n)])
    _, kfs_before = stages["before"]
    _, kfs_after = stages["refinement"]["poses"][1]

    def err(kfs):
        d = np.stack([p for _, p in kfs[:n]]) - truth
        return np.linalg.norm(d - d.mean(0), axis=1)
    before, after = err(kfs_before), err(kfs_after)
    assert before.mean() > 0.04
    assert after.mean() < before.mean() * 0.4, (before.mean(), after.mean())
    assert after.max() < 0.05, after


@pytest.mark.parametrize("cls", ["RefinementParams",
                                 "BatchOptimizationParams"])
def test_params_from_json_match_reference(cls):
    path = os.path.join(CONFIGS, "global_map", "global_map_refinement.json")
    pj = getattr(jref, cls).from_json(path, config_root=CONFIGS)
    pt = getattr(tref, cls).from_json(path, config_root=CONFIGS)
    for f in dataclasses.fields(pj):
        a, b = getattr(pt, f.name), getattr(pj, f.name)
        if hasattr(b, "_asdict"):   # the port's options lack `assembly`
            assert a._asdict() == {k: v for k, v in b._asdict().items()
                                   if k in a._fields}, f.name
        else:
            assert a == b, f.name
    # a copied reference behaviour: lc_min_traj_dist_m (metres) is taken as
    # the loop's minimum separation in seconds
    if cls == "BatchOptimizationParams":
        assert pt.loop_min_separation_s == 5.0
