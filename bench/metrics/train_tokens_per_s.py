"""Tokens of all the window's steps over its wall time, which ends at the
synchronise after the last step (host clock)."""


def read(ctx):
    w = ctx.window
    return w["tokens"] / w["wall_s"] if w.get("steps") else None
