"""Dispatch-amortized device timing (port of
:mod:`beam_slam_tpu.utils.timing`).

A single call timed between two host clock reads measures the launch and
the wait as much as the work. ``amortized_median_ms`` runs ``inner`` calls
of the function back to back and divides by ``inner``: on a CUDA device
between two ``torch.cuda.Event``s recorded on the current stream (the
device clock: only the wait for the first launch stays outside), on the
CPU with ``time.perf_counter``. The median over ``n_rep`` such chains is
the per-call time. ``chained_median_ms`` does the same for a self-feeding
step (``state → state``).

The reference chains its calls inside one jitted ``lax.scan`` whose carry
feeds back into the inputs (``perturb``), so that XLA cannot hoist the body
out of the loop as invariant. Eager PyTorch hoists nothing, so the port
needs no such feedback; ``perturb`` stays in the signature, and when a
caller gives one it is applied to the arguments of every call with the
carry of the chain (the float sum of the first output, times zero), so a
caller's feedback still applies.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
        return None
    if hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            t = _first_tensor(getattr(out, name))
            if t is not None:
                return t
    return None


def _device_of(*trees):
    for tree in trees:
        t = _first_tensor(tree)
        if t is not None:
            return t.device
    return torch.device("cpu")


def _time_chain(run_chain, length: int, device) -> float:
    """Seconds per call of one chain of ``length`` calls."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_chain(length)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / length
    t0 = time.perf_counter()
    run_chain(length)
    return (time.perf_counter() - t0) / length


def _median_ms(run_chain, length: int, reps: int, device) -> float:
    run_chain(length)  # warm (builds, caches, allocator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = sorted(_time_chain(run_chain, length, device)
                   for _ in range(reps))
    return 1e3 * times[len(times) // 2]


def amortized_median_ms(fn: Callable, *args,
                        perturb: Optional[Callable] = None,
                        n_rep: int = 8, inner: Optional[int] = None) -> float:
    """Median per-call milliseconds of ``fn(*args)`` with the launch and
    the wait amortized over ``inner`` back-to-back calls.

    ``inner`` is chosen adaptively when omitted, as the reference chooses
    it: a pilot chain of 16 calls (median of 3) sizes a chain of about
    0.5 s, between 16 and 2048 calls; when that is at most 24 calls the
    pilot's number stands, else the median of ``min(n_rep, 5)`` chains of
    that length is returned.

    ``perturb(args_tuple, acc) -> args_tuple``, when given, makes each
    call's inputs depend on the chain's carry ``acc``, a float32 scalar
    (the reference's hoisting guard, which eager PyTorch does not need)."""
    device = _device_of(args)

    def run_chain(length):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(length):
            a = perturb(args, acc) if perturb is not None else args
            out = fn(*a)
            if perturb is not None:
                first = _first_tensor(out)
                acc = acc + 0.0 * first.float().sum()

    if inner is not None:
        return _median_ms(run_chain, inner, n_rep, device)
    pilot = _median_ms(run_chain, 16, 3, device)
    length = max(16, min(2048, int(500.0 / max(pilot, 1e-3))))
    if length <= 24:  # pilot already amortized enough
        return pilot
    return _median_ms(run_chain, length, min(n_rep, 5), device)


def chained_median_ms(step: Callable, init, n_rep: int = 8,
                      inner: int = 16) -> float:
    """Median per-step ms of a self-feeding step: ``step(state) -> state``
    chained ``inner`` times (successive smoother ticks)."""
    device = _device_of(init)

    def run_chain(length):
        s = init
        for _ in range(length):
            s = step(s)

    return _median_ms(run_chain, inner, n_rep, device)
