"""The share of the traced steps' wall time in which no operation ran on
the device: 1 - (union of the device intervals) / wall, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
