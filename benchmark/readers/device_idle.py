"""Share of the traced window in which no operation ran on the device:
1 − (the union of the device's operation intervals) / (the window)."""


def read(ctx, spec):
    if ctx.trace is None or not ctx.trace.dev_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
