"""Griffin RG-LRU recurrent block (recurrentgemma-2b, arXiv:2402.19427) —
the port of the JAX package's ``models/griffin.py``.

Two input branches; the recurrent branch goes linear -> causal conv1d ->
RG-LRU, and the output is the gated product through an output projection:

    r_t = sigmoid(W_r x_t)          (recurrence gate)
    i_t = sigmoid(W_i x_t)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is kernel B7 (``repro_torch::rglru_scan``, through
``layers.linear_recurrence``) on both paths: over the whole prompt from
``h = 0`` in prefill (the reference's ``linear_recurrence_chunked``) and
with ``S = 1`` from the cached state in decode (the reference's one-step
``h = a·h + b``).  So every RG-LRU layer launches B7 exactly once per
model call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor

from .layers import causal_conv1d, linear_recurrence

__all__ = ["init_rglru_cache", "init_rglru_params", "rglru_block", "rglru_decode_step",
           "rglru_prefill"]

_C = 8.0


def init_rglru_params(cfg, dtype: torch.dtype, *, generator: torch.Generator,
                      device: torch.device) -> dict:
    """The reference's shapes and scales, drawn from ``generator`` on
    ``device``: ``lam`` stays f32 inside a bf16 model."""
    d, r, K = cfg.d_model, cfg.rnn_width, cfg.ssm_conv
    s, sr = d ** -0.5, r ** -0.5

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    lam = torch.linspace(0.3, 1.3, r, dtype=torch.float32, device=device)
    return {
        "w_y": normal((d, r), s),
        "w_x": normal((d, r), s),
        "conv_w": normal((K, r), 0.2),
        "conv_b": torch.zeros((r,), dtype=dtype, device=device),
        "w_r": normal((r, r), sr),
        "w_i": normal((r, r), sr),
        # Lambda init so that a ~ uniform(0.9, 0.999) at r=0.5 (Griffin A.2-ish)
        "lam": torch.log(torch.expm1(lam)),
        "w_o": normal((r, d), sr),
    }


def _rglru_gates(params, xc: torch.Tensor):
    """xc: [B, L, R] post-conv.  Returns (a, b) f32 for the recurrence."""
    r_gate = torch.sigmoid(torch.matmul(xc, params["w_r"]).float())
    i_gate = torch.sigmoid(torch.matmul(xc, params["w_i"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r_gate
    a = torch.exp(log_a)
    gated_x = i_gate * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x
    return a, b


def _rglru_core(params, x: torch.Tensor, conv_cache: torch.Tensor | None,
                h0: torch.Tensor | None):
    """Both branches, the conv, the gates and the recurrence (B7).  Returns
    ``(out [B, L, D], h_last [B, R], new conv cache)``.  On a mesh (a
    DTensor ``x``) the block runs whole on each rank's data shard
    (``dist.kernel_rules.replicated_block``)."""
    if is_dtensor(x):
        from repro_torch.dist import kernel_rules

        return kernel_rules.replicated_block(_rglru_core, params, x, conv_cache, h0)
    y_branch = F.gelu(torch.matmul(x, params["w_y"]), approximate="tanh")
    x_branch = torch.matmul(x, params["w_x"])
    xc, new_conv = causal_conv1d(x_branch, params["conv_w"], conv_cache)
    xc = xc + params["conv_b"]
    a, b = _rglru_gates(params, xc)
    hs, h_last = linear_recurrence(a, b, h0)                           # [B, L, R]
    out = hs.to(x.dtype) * y_branch
    return torch.matmul(out, params["w_o"]), h_last, new_conv


def rglru_block(params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, L, D] -> [B, L, D] (prefill path, h0 = 0)."""
    return _rglru_core(params, x, None, None)[0]


def rglru_prefill(params, x: torch.Tensor):
    """The block over the full prompt from a zero state, returning the
    output and the decode state ``{"h", "conv"}`` it leaves (the
    reference's ``transformer._rglru_prefill``; the conv state as in
    ``mamba.mamba_prefill``)."""
    out, h_last, conv = _rglru_core(params, x, None, None)
    return out, {"h": h_last, "conv": conv}


def init_rglru_cache(cfg, batch: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.rnn_width), dtype=dtype,
                            device=device),
    }


def rglru_decode_step(params, x: torch.Tensor, cache: dict):
    """x: [B, 1, D] -> ([B, 1, D], new cache): B7 with S = 1 from the cached
    state."""
    out, h, conv = _rglru_core(params, x, cache["conv"], cache["h"])
    return out, {"h": h, "conv": conv}
