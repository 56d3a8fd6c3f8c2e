"""Share of a timed call's wall that the host spends until the program's
call returns, before the synchronize: near 100% the host sets the pace;
low, the host waits for the card."""


def read(ctx, spec):
    enq = sum(s1 - s0 for s0, s1, _ in ctx.spans)
    wall = sum(s2 - s0 for s0, _, s2 in ctx.spans)
    return 100.0 * enq / wall
