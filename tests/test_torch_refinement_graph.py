"""Parity of the port's pose-graph stages of the offline map refinement
(beam_slam_tpu_torch.global_mapping.refinement) with the JAX package on the
CPU: the submap pose-graph optimization and the keyframe batch
optimization (ScanContext loop search, LOAM loop registrations, MAD outlier
rejection, the pose-graph solve).

The map is tests/test_torch_refinement.py's (two submaps of 3 and 2
keyframes, seeded pose noise, the synthetic scene seen from the truth),
with loop closure on. Both stages' graphs have 16 states and one set of
solver options in both packages (the batch stage's smoother at
max_keyframes=16; the pose-graph stage's GlobalMapper given the same), so
that the JAX package compiles one LM loop. Tolerances: stats equal, poses
within 2e-3 m / 2e-3 rad (float32 registrations and solves).
"""

import numpy as np
import pytest
import torch

from beam_slam_tpu_torch.global_mapping import refinement as tref
from beam_slam_tpu_torch.models import global_mapper as tgm
from beam_slam_tpu_torch.solver import gauss_newton as tgn
from beam_slam_tpu_torch.solver import smoother as tsm
from test_torch_global_map import map_to_port
from test_torch_refinement import (SmallGraph, assert_stage, build_noisy_map,
                                   run_stages)

torch.set_num_threads(2)

STAGES = ("pgo", "batch")


@pytest.fixture(scope="module")
def stages():
    return run_stages(STAGES)


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_reference(stages, name):
    assert_stage(stages[name], name)


def test_batch_optimization_keeps_loops(stages):
    """The keyframes of the two submaps are 10 s apart: the ScanContext
    search (the production config) finds loops between them, and the MAD
    rejection keeps them."""
    stats_j, stats_t = stages["batch"]["stats"]
    assert stats_t["keyframes"] == 5
    assert stats_t["loops_kept"] >= 1


def test_pgo_max_candidates_is_not_read(monkeypatch):
    """A copied reference behaviour: run_pose_graph_optimization takes
    max_candidates, and the loop search reads params.max_candidates
    instead."""
    seen = []
    gm = map_to_port(build_noisy_map(np.random.default_rng(2),
                                     counts=(1, 1, 1)))
    gm.params.loop_closure = True
    real = gm.candidate_search.find

    def find(submaps, query_idx, max_candidates=3):
        seen.append(max_candidates)
        return real(submaps, query_idx, max_candidates)
    monkeypatch.setattr(gm.candidate_search, "find", find)
    with SmallGraph(tgm, tsm, tgn):
        tref.run_pose_graph_optimization(gm, max_candidates=7)
    assert seen == [gm.params.max_candidates] * 3
