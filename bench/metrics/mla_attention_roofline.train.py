"""Kernels B3 and B3-bwd (``kernels/flash_attention``) at latent attention's
widths against their roofline, in %: the least time the device could take
for the traced steps' attention calls (each call the larger of its
operations over the peak bf16 rate and its bytes over the peak bandwidth,
from ``roofline/mla_attention.py``, at q / k heads of ``qk_nope_head_dim +
qk_rope_head_dim`` and v heads of ``v_head_dim``) over the device time of
the kernels named here.  None for a configuration without latent attention.

A forward kernel launch is one call; a backward call is its ``dQ`` launch
(it also launches a ``D`` pass and a ``dK, dV`` pass, whose time counts).
"""

FORWARD = ("flash_fwd",)
BACKWARD_CALL = ("flash_bwd_dq",)
ALL = ("flash_fwd", "flash_bwd")


def read(ctx):
    t, m = ctx.trace, ctx.model
    if t is None or not ctx.peaks or not m.get("kv_lora_rank"):
        return None
    seconds = t.kernel_seconds(ALL)
    n_fwd, n_bwd = t.count(FORWARD), t.count(BACKWARD_CALL)
    if seconds <= 0 or not (n_fwd or n_bwd):
        return None
    mix = ctx.traffic
    shape = (int(mix["batch"]), int(mix["seq_len"]), m["n_heads"],
             m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"], 2)
    att = ctx.roofline("mla_attention")

    def bound(work):
        flops, nbytes = work
        return max(flops / ctx.peaks["bf16_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])

    least = n_fwd * bound(att.forward(*shape)) + n_bwd * bound(att.backward(*shape))
    return 100.0 * least / seconds
