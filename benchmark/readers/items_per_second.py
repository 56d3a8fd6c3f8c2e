"""Items solved (the cell's items per timed call times the calls) over the
window's wall seconds."""


def read(ctx, spec):
    return ctx.items / ctx.window_s
