"""Device milliseconds a timed call of every device operation (kernels,
copies, fills) that is not K1, from the profiler's trace."""


def read(ctx, spec):
    if ctx.trace is None:
        return None
    ns = sum(e - s for n, s, e in ctx.trace.dev_ops
             if not any(k in n for k in spec["k1_kernels"]))
    return ns / 1e6 / ctx.n_solves
