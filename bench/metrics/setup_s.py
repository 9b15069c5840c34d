"""Seconds from the process's start to the first timed step, less the
check's readings between the first steps (host clock)."""


def read(ctx):
    return ctx.setup_s
