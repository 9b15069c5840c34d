"""Shared neural-net layers, as plain functions on tensors.

Each function follows its counterpart in the JAX package's
``models/layers.py`` op for op: the same f32 upcasts, the same places where
results round back to the working dtype, and the same ``-1e30`` mask
constant, so the port's logits match the reference's on the same weights.
The sharding annotations of the reference are no-ops without a mesh and
are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention as _decode_attention_op
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention_op
from repro_torch.kernels.flash_attention import flash_attention_train as _flash_attention_train
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru_scan_op

__all__ = ["rms_norm", "apply_rope", "glu_ffn", "chunked_attention", "decode_attention",
           "masked_attention", "causal_conv1d", "linear_recurrence"]

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs            # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                     # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def glu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (act='silu') / GeGLU (act='gelu') feed-forward.  ``gelu`` is
    the tanh approximation, as ``jax.nn.gelu`` computes by default."""
    a = torch.matmul(x, w_gate)
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    b = torch.matmul(x, w_up)
    return torch.matmul(a * b, w_down)


def chunked_attention(
    q: torch.Tensor,   # [B, Sq, Hq, hd]
    k: torch.Tensor,   # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    chunk: int = 2048,
    q_chunk: int = 2048,
) -> torch.Tensor:
    """GQA attention with flash semantics (the prefill attention): one
    ``repro_torch::flash_attention`` node — the hand-written kernel on a
    CUDA tensor, the reference's online softmax over KV ``chunk`` s and Q
    ``q_chunk`` s on a CPU tensor.  ``q_offset``: absolute position of
    q[0].  The reference's ``kv_len`` (decode against a longer cache) has
    no caller on the ported paths and is not taken.

    Where autograd records (grad enabled and an input requires grad: the
    training forward) it is one ``repro_torch::flash_attention_train``
    node instead, the same forward that keeps each row's log-sum-exp for
    its gradient, the backward kernel."""
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    op = _flash_attention_train if train else _flash_attention_op
    return op(q, k, v, causal=causal, window=window, q_offset=q_offset, chunk=chunk,
              q_chunk=q_chunk)


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, hd]
    k_cache: torch.Tensor,  # [B, Smax, Hkv, hd] (linear or ring buffer)
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,   # [Smax] | [B, Smax] absolute position per slot; -1 = empty
    q_pos: torch.Tensor,    # [] | [B] absolute position of the query token
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention against a dense KV cache: one
    ``repro_torch::decode_attention`` node.  A 2-D ``kv_pos`` (with ``q_pos``
    per row) is the continuous-batching layout: every row is a request at
    its own decode position over its own slice of the cache."""
    return _decode_attention_op(q, k_cache, v_cache, kv_pos, q_pos, window=window)


def masked_attention(
    q: torch.Tensor,        # [B, Sq, Hq, hd]
    k: torch.Tensor,        # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    kv_pos: torch.Tensor,   # [Skv] | [B, Skv] absolute position per entry; -1 = empty
    q_pos: torch.Tensor,    # [Sq]  | [B, Sq] absolute position per query row
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Position-table-masked GQA attention for ``Sq >= 1`` query rows: an
    entry is kept iff occupied, causally visible and inside the window."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd) * hd ** -0.5
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k).float()
    kvp = kv_pos if kv_pos.dim() == 2 else kv_pos[None]    # [B|1, Skv]
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]        # [B|1, Sq]
    keep = (kvp[:, None, :] >= 0) & (kvp[:, None, :] <= qp[:, :, None])
    if window is not None:
        keep = keep & (kvp[:, None, :] > qp[:, :, None] - window)
    s = torch.where(keep[:, None, None, :, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence axis.

    x: [B, S, C]; w: [K, C].  Returns ([B, S, C], new_cache [B, K-1, C]):
    ``cache`` carries the last K-1 positions for streaming decode (zeros
    when absent)."""
    K = w.shape[0]
    if cache is None:
        cache = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([cache, x], dim=1)
    S = x.shape[1]
    # the taps summed in the reference's order (its sum() starts from 0)
    out = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    new_cache = xp[:, -(K - 1):, :] if K > 1 else cache
    return out.to(x.dtype), new_cache


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1, from ``h0 [B, ...]``
    (zeros when absent), returning (all h [B, S, ...] f32, h_S f32): the
    reference's ``linear_recurrence_chunked``, as one
    ``repro_torch::rglru_scan`` node over the flattened trailing axes —
    kernel B7 on a CUDA tensor, the step-by-step plain version on a CPU
    tensor (the reference's chunked associative scan sums in another
    order)."""
    B, S = a.shape[0], a.shape[1]
    tail = a.shape[2:]
    flat = (B, S, math.prod(tail))
    hs, h_last = _rglru_scan_op(a.reshape(flat), b.reshape(flat),
                                None if h0 is None else h0.reshape(B, -1))
    return hs.reshape((B, S) + tuple(tail)), h_last.reshape((B,) + tuple(tail))
