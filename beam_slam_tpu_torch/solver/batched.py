"""Shared-topology batched LM solve — the submap-refinement throughput path
(port of :mod:`beam_slam_tpu.solver.batched`).

B independent windows of the SAME factor-graph template
(bs_models/src/lib/global_mapping/submap_refinement.cpp:24-162): every
family's ``slots``/``active`` and every window capacity are equal across the
leading batch axis, so one set of slot indices serves all B windows. The
factor math and the scatter assembly of :mod:`.gauss_newton` are written
over leading batch dims; here they run on ``[B, ...]`` windows, scattering
into ``[B, D+1, D+1]`` normal equations over the shared indices, and every
LM iteration solves the B reduced systems in one K1 launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from beam_slam_tpu_torch.core.window import WindowState
from beam_slam_tpu_torch.solver import gauss_newton as gn


def assert_shared_topology(families_b) -> None:
    """Host-side check that every family's slots/active are batch-constant."""
    for fam in families_b:
        if not torch.equal(fam.slots, fam.slots[:1].expand_as(fam.slots)):
            raise ValueError(
                f"{type(fam).__name__}: slots differ across the batch — "
                "the shared-topology solve does not apply")
        if not torch.equal(fam.active, fam.active[:1].expand_as(fam.active)):
            raise ValueError(
                f"{type(fam).__name__}: active masks differ across the batch")


def solve_batched_shared(window_b: WindowState, families_b,
                         losses: Tuple[Optional[float], ...],
                         options: gn.SolverOptions = gn.SolverOptions()):
    """Batched LM over B same-topology windows (leading axis of every leaf).

    ``gn.lm_loop`` is batch-polymorphic: with ``[B]``-shaped LM scalars it is
    the reference's ``lm_loop_batched`` (per-window damping, accept and
    convergence latch). The shared-topology contract is the caller's to
    check, with :func:`assert_shared_topology` (a host sync)."""
    return gn.lm_loop(
        window_b,
        lambda w: gn.assemble_normal_equations(w, families_b, losses),
        options.max_iterations, options)
