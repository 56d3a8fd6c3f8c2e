"""Parity of the port's submap alignment (beam_slam_tpu_torch.
global_mapping.refinement.run_submap_alignment) with the JAX package on the
CPU, and the port's refinement CLI on a map the JAX package saved.

The map is tests/test_torch_refinement.py's (two submaps of 3 and 2
keyframes, seeded pose noise, the synthetic scene seen from the truth).
Tolerances: the count of alignments equal, submap and keyframe poses
within 2e-3 m / 2e-3 rad (float32 registrations).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from beam_slam_tpu.global_mapping import global_map as jgmap
from test_torch_global_map import CONFIGS, ROOT
from test_torch_refinement import assert_stage, build_noisy_map, run_stages

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stages():
    return run_stages(("alignment",))


def test_alignment_matches_reference(stages):
    assert_stage(stages["alignment"], "alignment")
    assert stages["alignment"]["stats"][1] == 1


def test_refinement_cli_on_a_jax_map(tmp_path):
    """The port's CLI, on the CPU, on a map the JAX package saved; its
    output loads into the JAX package."""
    gm = build_noisy_map(np.random.default_rng(1), counts=(2, 2))
    gm.save(str(tmp_path / "in"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m",
         "beam_slam_tpu_torch.tools.global_map_refinement_main",
         "--globalmap_dir", str(tmp_path / "in"),
         "--output_path", str(tmp_path / "out"),
         "--run_submap_refinement",
         "--refinement_config", "global_map/global_map_refinement.json",
         "--config_root", CONFIGS, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(tmp_path / "out" / "refinement_stats.json") as f:
        stats = json.load(f)
    assert set(stats) == {"refinement_cost", "wall_s"}
    gm2 = jgmap.GlobalMap.load(str(tmp_path / "out"))
    assert [len(s.lidar_keyframes) for s in gm2.submaps] == [2, 2]
    moved = max(np.abs(a.p - b.p).max() for s2, s in zip(gm2.submaps,
                                                          gm.submaps)
                for a, b in zip(s2.lidar_keyframes, s.lidar_keyframes))
    assert moved > 1e-3
