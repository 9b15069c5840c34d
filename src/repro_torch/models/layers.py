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

__all__ = ["rms_norm", "apply_rope", "glu_ffn", "masked_attention"]

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
