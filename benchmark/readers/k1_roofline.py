"""Kernel K1's share of its roofline: the least time its work could take
on the card over the profiler's device time of one launch.

The work is the dense Cholesky factor and solve the program runs today, B
systems of N unknowns: B·(N³/3 + 2N²) operations and B·(N² + 2N)·4 bytes
(the matrix read once, the right-hand side read and the answer written).
N is the size that the cell's inputs need (``system.k1_shape``), not what
the kernel pads to. The least time is the larger of the operations over
the card's float32 rate without tensor cores and the bytes over its
memory bandwidth (``peaks.json``). A program that changes K1's algorithm
(a sparse factorization, say) needs these counts redone."""


def bound_s(B, N, peaks):
    ops = B * (N ** 3 / 3.0 + 2.0 * N * N)
    nbytes = B * (N * N + 2.0 * N) * 4.0
    return max(ops / peaks["fp32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(ctx, spec):
    if ctx.trace is None:
        return None
    k1 = [e - s for n, s, e in ctx.trace.dev_ops
          if any(k in n for k in spec["kernels"])]
    if not k1:
        return None
    B, N = ctx.system.k1_shape
    per_launch_s = sum(k1) / len(k1) / 1e9
    return 100.0 * bound_s(B, N, ctx.peaks) / per_launch_s
