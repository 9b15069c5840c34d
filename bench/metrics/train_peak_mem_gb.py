"""``torch.cuda.max_memory_allocated()`` over the window, reset after the
set-up, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.window_peak / 1e9 if ctx.window_peak else None
