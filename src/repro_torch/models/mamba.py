"""Mamba-1 block (falcon-mamba-7b) — the port of the JAX package's
``models/mamba.py``: a selective state-space model over a recurrent state
cache.

The selective scan is kernel B6 (``repro_torch::ssm_scan``) on both paths:

* :func:`mamba_block` (and the transformer's ``_mamba_prefill``) runs it
  over the whole prompt from ``h = 0`` — the reference computes this scan
  in jnp (``ssm_scan_fused``, a chunked associative scan);
* :func:`mamba_decode_step` runs it with ``S = 1`` from the cached state —
  the reference's one-step update ``h = a·h + b``, ``y = Σ h·c`` is the
  same function.

So every Mamba layer launches B6 exactly once per model call.  Where
autograd records (grad enabled and an input requires grad: the training
forward) it is one ``repro_torch::ssm_scan_train`` node instead, the same
kernel keeping a checkpoint of the state every 32 steps for its gradient,
the backward kernel.  The
discretisation ``a = exp(dt·A)``, ``b = dt·B·x`` is materialised as the
kernel's input (``[B, L, d_inner, state]`` f32), op for op the reference's
``_ssm_inputs``; capture folds it into the scan's node.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_train

from .layers import causal_conv1d

__all__ = [
    "init_mamba_cache",
    "init_mamba_params",
    "mamba_block",
    "mamba_decode_step",
]


def init_mamba_params(cfg, dtype: torch.dtype, *, generator: torch.Generator,
                      device: torch.device) -> dict:
    """The reference's shapes and scales, drawn from ``generator`` on
    ``device``: ``dt_bias``, ``A_log`` and ``D`` stay f32 inside a bf16
    model."""
    d, di, st, dr, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    f32 = {"dtype": torch.float32, "device": device}
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((K, di), 0.2),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal((di, dr + 2 * st), di ** -0.5),
        "dt_proj": normal((dr, di), dr ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, **f32))),
        # S4D-real init: A = -(1..state)
        "A_log": torch.log(torch.arange(1, st + 1, **f32).repeat(di, 1)),
        "D": torch.ones((di,), **f32),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _ssm_inputs(params, xconv: torch.Tensor):
    """The shared projection math (the reference's ``_ssm_inputs``).
    xconv: [B, L, di] post-conv post-silu.  Returns ``(a, b [B, L, di, st]
    f32, C [B, L, st])`` — the scan's decay, input and output projection."""
    dbc = torch.matmul(xconv, params["x_proj"])
    dr = params["dt_proj"].shape[0]
    st = params["A_log"].shape[1]
    dt, B_ssm, C_ssm = torch.split(dbc, [dr, st, st], dim=-1)
    dt = F.softplus(torch.matmul(dt, params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                                   # [di, st]
    a = torch.exp(dt[..., None] * A)
    b = dt[..., None] * B_ssm[:, :, None, :].float() * xconv[..., None].float()
    return a, b, C_ssm


def _mamba_core(params, x: torch.Tensor, conv_cache: torch.Tensor | None,
                h0: torch.Tensor | None):
    """in_proj -> causal conv -> silu -> selective scan (B6) -> D skip ->
    silu gate -> out_proj.  Returns ``(out [B, L, D], h_last, new conv
    cache)``.  On a mesh (a DTensor ``x``) the block runs whole on each
    rank's data shard (``dist.kernel_rules.replicated_block``)."""
    if is_dtensor(x):
        from repro_torch.dist import kernel_rules

        return kernel_rules.replicated_block(_mamba_core, params, x, conv_cache, h0)
    xz = torch.matmul(x, params["in_proj"])
    xpart, res = torch.chunk(xz, 2, dim=-1)                            # [B, L, di] each
    xconv, new_conv = causal_conv1d(xpart, params["conv_w"], conv_cache)
    xconv = F.silu(xconv + params["conv_b"])
    a, b, C_ssm = _ssm_inputs(params, xconv)
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, C_ssm, h0))
    y, h_last = (ssm_scan_train if train else ssm_scan)(a, b, C_ssm, h0)
    y = y + params["D"] * xconv.float()
    y = y * F.silu(res.float())
    return torch.matmul(y.to(x.dtype), params["out_proj"]), h_last, new_conv


def mamba_block(params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, L, D] -> [B, L, D] (prefill path, h0 = 0)."""
    return _mamba_core(params, x, None, None)[0]


def mamba_prefill(params, x: torch.Tensor):
    """Mamba over the full prompt from a zero state, returning the output
    and the decode state ``{"h", "conv"}`` it leaves (the reference's
    ``transformer._mamba_prefill``).  The conv state is the last K-1
    positions of the zero-padded input, which is the reference's
    ``xpart[:, -(K-1):]`` whenever the prompt has K-1 tokens or more (and
    has the cache's shape when it has fewer)."""
    out, h_last, conv = _mamba_core(params, x, None, None)
    return out, {"h": h_last, "conv": conv}


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }


def mamba_decode_step(params, x: torch.Tensor, cache: dict):
    """Single-token step. x: [B, 1, D] -> ([B, 1, D], new cache): B6 with
    S = 1 from the cached state."""
    out, h, conv = _mamba_core(params, x, cache["conv"], cache["h"])
    return out, {"h": h, "conv": conv}
