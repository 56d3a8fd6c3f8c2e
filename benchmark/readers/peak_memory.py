"""Peak device memory the program's allocator held over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in GiB."""


def read(ctx, spec):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
