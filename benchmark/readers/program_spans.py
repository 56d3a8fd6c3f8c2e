"""Host self time and idle card by layer of the program, from the spans it
records under the profiler (``beam_slam_tpu_torch.obs.trace``).

The spans kept are those of the thread that ran the window's solves (the
most spans named ``spec["root"]``) that start inside the traced window
[``ctx.trace.t0``, ``ctx.trace.t1``]. A span's self time is the stretch
in which it is the innermost open span of that thread. The metric's
spans are ``spec["spans"]``; ``spec["quantity"]`` is

* ``self_ms``: their self time, in ms, over the window's solves;
* ``idle_pct``: the share of the traced window in which the card ran no
  operation (``harness.idle_gaps`` of ``ctx.trace.dev_ops``) while the
  host was in their self time. The shares of disjoint span sets, plus
  the idle time outside them, add up to the window's idle share.

Returns None without a trace, without the program's recorder (a program
that records no spans), without spans in the window, or if the recorder
dropped any span. The arithmetic is this file's own: the recorder only
hands over its raw spans.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import harness


def _raw_spans():
    """The program's recorded spans, or None if it has no recorder or
    dropped any span."""
    try:
        from beam_slam_tpu_torch.obs import trace
    except ImportError:
        return None
    if trace.dropped():
        return None
    return trace.spans()


def window_spans(spans, root: str, t0: int, t1: int) -> List:
    """Closed spans that start in [t0, t1] on the thread that ran the most
    of the window's ``root`` spans."""
    inside = [s for s in spans if s.end is not None and t0 <= s.start <= t1]
    roots: Dict[int, int] = {}
    for s in inside:
        if s.name == root:
            roots[s.thread] = roots.get(s.thread, 0) + 1
    if not roots:
        return []
    thread = max(roots, key=roots.get)
    return [s for s in inside if s.thread == thread]


def innermost(spans) -> List[Tuple[int, int, str]]:
    """(start, end, name) stretches in which each span is the innermost
    open one, for the spans of one thread (nested, as a stack makes
    them)."""
    out, stack = [], []   # stack: [name, end, cursor]

    def close():
        name, end, cursor = stack.pop()
        if end > cursor:
            out.append((cursor, end, name))
        if stack:
            stack[-1][2] = max(stack[-1][2], end)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][1] <= s.start:
            close()
        end = s.end
        if stack:
            top = stack[-1]
            if s.start > top[2]:
                out.append((top[2], s.start, top[0]))
            end = min(end, top[1])
        stack.append([s.name, end, s.start])
    while stack:
        close()
    return out


def overlap_ns(stretches, gaps) -> Dict[str, int]:
    """Time by name in which the stretches (start, end, name) overlap the
    gaps (start, end); both lists sorted by start, each disjoint."""
    out: Dict[str, int] = {}
    j = 0
    for s, e, name in stretches:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            lap = min(e, gaps[k][1]) - max(s, gaps[k][0])
            if lap > 0:
                out[name] = out.get(name, 0) + lap
            k += 1
    return out


def stretches(ctx, spec) -> Optional[List[Tuple[int, int, str]]]:
    """The innermost stretches of the window's spans in order of start;
    None where there is nothing to read."""
    if ctx.trace is None:
        return None
    spans = _raw_spans()
    if spans is None:
        return None
    kept = window_spans(spans, spec["root"], ctx.trace.t0, ctx.trace.t1)
    return sorted(innermost(kept)) if kept else None


def read(ctx, spec):
    parts = stretches(ctx, spec)
    if parts is None:
        return None
    names = set(spec["spans"])
    if spec["quantity"] == "self_ms":
        ns = sum(e - s for s, e, n in parts if n in names)
        return ns / 1e6 / ctx.n_solves
    gaps = harness.idle_gaps([(s, e) for _, s, e in ctx.trace.dev_ops],
                             ctx.trace.t0, ctx.trace.t1)
    ns = sum(v for n, v in overlap_ns(parts, gaps).items() if n in names)
    return 100.0 * ns / (ctx.trace.t1 - ctx.trace.t0)
