"""Batched window solves of mixed topologies and the submap-sharded
refinement step (port of :mod:`beam_slam_tpu.parallel.sharded`).

The reference vmaps its window LM solve over a leading batch axis and, with
a device mesh, shards that axis over the chips (SURVEY.md §7.8). The port
runs on one card. Its :class:`Mesh` keeps the reference's mesh interface
(axis names, the shape of each axis, the shard count, a device per shard)
with every shard on that one card; a mesh over two distinct CUDA devices
raises ``NotImplementedError``, since a cross-device reduction would be
code no run has tried. What the solve keeps is the vmapped solve itself: B
independent windows whose factor families may differ in ``active`` and in
``slots``. Each window's factors are gathered and scattered at its own
slots (``per_window`` in :func:`gauss_newton.assemble_normal_equations`),
and every LM step solves the B reduced systems in one K1 call — no loop
over windows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from beam_slam_tpu_torch.core.window import WindowState
from beam_slam_tpu_torch.device import resolve
from beam_slam_tpu_torch.solver import gauss_newton as gn

SUBMAP_AXIS = "submaps"


class Mesh:
    """A named grid of shards, all on one device: the port's stand-in for
    ``jax.sharding.Mesh``. ``shape`` maps each axis name to its size, in
    order; ``size`` is the shard count; ``devices`` lists one device per
    shard (all the same)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 device):
        if len(axis_names) != len(sizes) or any(int(n) < 1 for n in sizes):
            raise ValueError(f"mesh axes {axis_names} with sizes {sizes}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n)
                                      for a, n in zip(axis_names, sizes)}
        self.device = torch.device(device)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.devices = [self.device] * self.size

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def mesh_device(devices=None) -> torch.device:
    """The one device a mesh over ``devices`` lives on: the card when
    ``devices`` is None. Raises ``NotImplementedError`` when ``devices``
    names more than one distinct device."""
    if devices is None:
        return resolve(None)
    distinct = {torch.device(d) for d in devices}
    if len(distinct) != 1:
        raise NotImplementedError(
            f"a mesh over {len(distinct)} distinct devices "
            f"({sorted(map(str, distinct))}): the port runs on one card, "
            f"and a cross-device reduction has never run")
    dev = distinct.pop()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_shard_count(devices=None) -> int:
    """The reference's default, one shard a device: ``len(devices)`` when
    given, else the visible CUDA device count."""
    if devices is not None:
        return len(devices)
    return torch.cuda.device_count()


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over the submap axis."""
    n = n_devices or default_shard_count(devices)
    return Mesh((SUBMAP_AXIS,), (n,), mesh_device(devices))


def shard_batch(tree, mesh: Mesh):
    """Place a leading-batch tree (a tensor or a struct of tensors) on the
    mesh's device; every shard is that device, so the batch axis needs no
    split."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(t, mesh) for t in tree)
    return tree.to(mesh.device)


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


def _pad_batch(tree, n: int):
    """Repeat entry 0 of every leaf ``n`` times at the end of the batch."""
    return tree.map(lambda t: torch.cat(
        [t, t[:1].expand((n,) + t.shape[1:])]))


def distributed_refinement_step(mesh: Mesh, windows, families, losses,
                                options: gn.SolverOptions):
    """One step of distributed submap refinement: the submap batch over the
    mesh's shards, each submap's window solved, the summed final cost as
    the convergence signal (global_map_refinement.cpp pattern). A batch
    that the shard count does not divide is padded with copies of its
    first window, as sharding needs, and the copies are dropped after the
    solve. All windows are one :func:`solve_batched` call: one K1 launch
    of B systems a LM step.

    Returns (solved windows, diagnostics, total final cost scalar)."""
    B = windows.imu.q.shape[0]
    pad = (-B) % mesh.size
    windows = shard_batch(windows, mesh)
    families = shard_batch(tuple(families), mesh)
    if pad:
        windows = _pad_batch(windows, pad)
        families = tuple(_pad_batch(f, pad) for f in families)
    out_windows, diags = solve_batched(windows, families, losses, options)
    if pad:
        out_windows = out_windows.map(lambda t: t[:B])
        diags = type(diags)(*(d[:B] for d in diags))
    total = torch.sum(diags.final_cost)
    return out_windows, diags, total

