"""Kernels B5 and B5-bwd (``kernels/moe_gmm``) against their roofline, in %:
the least time for the traced steps' expert products (each the larger of
its operations over the peak bf16 rate and its bytes over the peak
bandwidth, from ``roofline/moe_gmm.py``, over the rows the routing keeps as
the reference works them out again: the mean per layer over the steps it
follows) over the device time of the kernels named here.

A forward launch is one product (gate, up or down); a backward product is
one ``wgmma`` launch or two SIMT launches.
"""

FORWARD = ("gmm_narrow_mma", "gmm_wide_mma", "moe_gmm_simt")
BACKWARD = ("gmm_bwd_wgmma",)
BACKWARD_PAIR = ("gmm_bwd_simt",)
ALL = FORWARD + BACKWARD + BACKWARD_PAIR


def read(ctx):
    t = ctx.trace
    m = ctx.model
    kept = [k for step in ctx.reference.get("kept", []) for k in step]
    if t is None or not ctx.peaks or not m["n_experts"] or not kept:
        return None
    seconds = t.kernel_seconds(ALL)
    n_fwd = t.count(FORWARD)
    n_bwd = t.count(BACKWARD) + t.count(BACKWARD_PAIR) / 2
    if seconds <= 0 or not (n_fwd or n_bwd):
        return None
    rows = sum(kept) / len(kept)
    gmm = ctx.roofline("moe_gmm")
    shape = (rows, m["n_experts"], m["d_model"], m["d_ff"], 2)

    def bound(work):
        flops, nbytes = work
        return max(flops / ctx.peaks["bf16_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])

    least = n_fwd * bound(gmm.forward(*shape)) + n_bwd * bound(gmm.backward(*shape))
    return 100.0 * least / seconds
