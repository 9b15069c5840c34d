"""Kernels per step in the traced steps' device trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.steps
