"""The window's wall seconds over the number of whole timed calls it ran,
each ended by a device synchronize."""


def read(ctx, spec):
    return ctx.window_s / ctx.n_solves
