"""A ratio of two of the program's counters (``beam_slam_tpu_torch.obs.
trace``), in %, over the window's solves: ``spec["numerator"]`` over
``spec["denominator"]``, each summed over the solves whose root span
(named ``spec["root"]``) starts inside the traced window.

Returns None without a trace, without the program's recorder, if the
recorder dropped any span, or where the window's solves counted nothing
of the denominator. Reads the
program's device counters: the harness has synchronized after every
solve.
"""

from __future__ import annotations


def read(ctx, spec):
    if ctx.trace is None:
        return None
    try:
        from beam_slam_tpu_torch.obs import trace
    except ImportError:
        return None
    if trace.dropped():
        return None
    roots = {s.root for s in trace.spans()
             if s.name == spec["root"] and s.end is not None
             and ctx.trace.t0 <= s.start <= ctx.trace.t1}
    by_root = trace.counters(by_root=True)
    num = sum(by_root.get(r, {}).get(spec["numerator"], 0) for r in roots)
    den = sum(by_root.get(r, {}).get(spec["denominator"], 0) for r in roots)
    if den == 0:
        return None
    return 100.0 * num / den
