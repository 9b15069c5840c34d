"""The window's model operations (``roofline/train_step.py``) over its wall
time, as a share of the device's peak bf16 rate, in %."""


def read(ctx):
    w = ctx.window
    if not w.get("steps") or not ctx.peaks:
        return None
    per_step = ctx.roofline("train_step").flops(ctx.model, int(ctx.traffic["batch"]),
                                                int(ctx.traffic["seq_len"]))
    return 100.0 * per_step * w["steps"] / w["wall_s"] / ctx.peaks["bf16_flops"]
