"""Host milliseconds inside the program's step per step: the benchmark's
own span around each ``train_step`` call, all the window's steps over all
their time (host clock)."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["host_s"] / w["steps"] if w.get("steps") else None
