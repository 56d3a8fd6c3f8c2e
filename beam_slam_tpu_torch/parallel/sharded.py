"""Batched window solves of mixed topologies (port of the single-device
part of :mod:`beam_slam_tpu.parallel.sharded`).

The reference vmaps its window LM solve over a leading batch axis and, with
a device mesh, shards that axis over the chips (SURVEY.md §7.8). The port
runs on one card and has no mesh (``make_mesh``, ``shard_batch`` and
``distributed_refinement_step`` stay in the JAX package). What it keeps is
the vmapped solve itself: B independent windows whose factor families may
differ in ``active`` and in ``slots``. Each window's factors are gathered
and scattered at its own slots (``per_window`` in
:func:`gauss_newton.assemble_normal_equations`), and every LM step solves
the B reduced systems in one K1 call — no loop over windows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from beam_slam_tpu_torch.core.window import WindowState
from beam_slam_tpu_torch.solver import gauss_newton as gn


def solve_batched(windows: WindowState, families,
                  losses: Tuple[Optional[float], ...],
                  options: gn.SolverOptions = gn.SolverOptions()):
    """The window LM solve over a leading batch axis of every leaf of
    ``windows`` and ``families`` (``[B, ...]``), each window with its own
    slots, damping, accept and convergence latch: the reference's
    ``vmap(gn.solve)``. Returns (windows, diagnostics with ``[B]``
    leaves)."""
    n_iter = min(options.max_iterations,
                 options.scan_length or options.max_iterations)
    return gn.lm_loop(
        windows,
        lambda w: gn.assemble_normal_equations(w, families, losses,
                                               per_window=True),
        n_iter, options)


def global_cost(windows: WindowState, families,
                losses: Tuple[Optional[float], ...]) -> torch.Tensor:
    """Total robustified cost over all windows of the batch."""
    return torch.sum(gn.total_cost(windows, families, losses,
                                   per_window=True))
