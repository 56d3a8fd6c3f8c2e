"""Seconds from process start to the first timed call: imports, the
program's kernel load or build, the inputs made from the seed and the
warm-up of the cell's shapes."""


def read(ctx, spec):
    return ctx.setup_s
