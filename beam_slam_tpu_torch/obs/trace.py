"""The port's span and counter recorder.

Spans mark the layers of a solve (the LM loop, its steps, assembly,
linearization, the damped system, K1's host call); counters count what a
solve did (LM steps run and accepted). Both record only while a torch
profiler is active, or inside :func:`recording` (an operator's own
script), so a profiled run records and any other run pays one flag check
a span or counter, creates no ``record_function`` and runs no device op.

While recording, each :func:`span` stores its name, its start and end on
``time.time_ns()`` (the clock of the profiler's events, so spans and the
device's operations can be intersected), the index of its parent span
(a stack per thread: the smoother's worker thread solves too), the ID of
its root span (the solve that caused it), its thread and its attributes,
and opens a ``torch.profiler.record_function`` range of its name when a
profiler is active. Spans are kept in memory, at most ``MAX_SPANS``;
what does not fit is counted in :func:`dropped`, never written out.

:func:`count` adds to a host counter, :func:`count_device` adds a device
tensor into a device accumulator without a host read; both are kept per
root span. :func:`counters` reads them, so call it only after the device
has synchronized. :func:`reset` forgets every span and counter.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

MAX_SPANS = 100_000

_profiler_enabled = torch._C._autograd._profiler_enabled
_record_function = torch.autograd.profiler.record_function

_lock = threading.Lock()
_local = threading.local()
_root_ids = itertools.count(1)
_forced = 0
_records: List[list] = []     # [name, start, end, parent, root, thread, attrs]
_dropped = 0
_host: Dict[int, Dict[str, int]] = defaultdict(dict)
_device: Dict[int, Dict[str, torch.Tensor]] = defaultdict(dict)


class SpanRecord(NamedTuple):
    """One recorded span; ``end`` is None while it is open, ``parent`` is
    the index of the enclosing span in :func:`spans` (-1: none, or it was
    dropped), ``root`` the ID of the outermost span of its thread's
    stack."""

    name: str
    start: int
    end: Optional[int]
    parent: int
    root: int
    thread: int
    attrs: dict


class recording:
    """Record spans and counters inside this block, with or without a
    profiler (for an operator's own timing script)."""

    def __enter__(self):
        global _forced
        with _lock:
            _forced += 1
        return self

    def __exit__(self, *exc):
        global _forced
        with _lock:
            _forced -= 1
        return False


class _Null:
    def __enter__(self):
        pass

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "attrs", "rf", "rec")

    def __init__(self, name, attrs, profiled):
        self.name, self.attrs = name, attrs
        self.rf = _record_function(name) if profiled else None

    def __enter__(self):
        global _dropped
        if self.rf is not None:
            self.rf.__enter__()
        stack = _stack()
        if stack:
            parent, root = stack[-1]
        else:
            parent, root = -1, next(_root_ids)
        rec = [self.name, time.time_ns(), None, parent, root,
               threading.get_ident(), self.attrs]
        with _lock:
            if len(_records) < MAX_SPANS:
                index = len(_records)
                _records.append(rec)
            else:
                index = -1
                _dropped += 1
        stack.append((index, root))
        self.rec = rec

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one layer's work, recorded with its
    attributes ``attrs`` while recording is on."""
    profiled = _profiler_enabled()
    if not (profiled or _forced > 0):
        return _NULL
    return _Span(name, attrs, profiled)


def _root() -> int:
    stack = _stack()
    return stack[-1][1] if stack else 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` of the current solve."""
    if not (_forced > 0 or _profiler_enabled()):
        return
    root = _root()
    with _lock:
        c = _host[root]
        c[name] = c.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d integer or bool tensor ``t`` into the device counter
    ``name`` of the current solve, on ``t``'s device, without a host
    read."""
    if not (_forced > 0 or _profiler_enabled()):
        return
    root = _root()
    with _lock:
        c = _device[root]
        acc = c.get(name)
        if acc is None:
            c[name] = t.detach().to(torch.int64, copy=True)
        else:
            acc.add_(t.detach())


def spans() -> List[SpanRecord]:
    """Every recorded span, in the order they started."""
    with _lock:
        return [SpanRecord(*r) for r in _records]


def dropped() -> int:
    """Spans not kept because the buffer was full."""
    return _dropped


def counters(by_root: bool = False):
    """Counter totals ``{name: n}``, or ``{root: {name: n}}`` with
    ``by_root`` (root 0: counted outside any span). Reads the device
    counters: call it only after the device has synchronized."""
    with _lock:
        per = {r: dict(c) for r, c in _host.items()}
        for r, c in _device.items():
            d = per.setdefault(r, {})
            for k, v in c.items():
                d[k] = d.get(k, 0) + int(v)
    if by_root:
        return per
    total: Dict[str, int] = {}
    for c in per.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def reset() -> None:
    """Forget every span and counter."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
        _host.clear()
        _device.clear()

