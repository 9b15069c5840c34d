"""Mixture-of-Experts FFN: grouped top-k routing with capacity-based gather
dispatch — the port of the JAX package's ``models/moe.py``.

Tokens are split into ``n_groups`` groups routed independently, each with
its own per-expert capacity (the reference takes the mesh's data-parallel
extent; this package has no mesh yet, so ``n_groups=None`` is one group, as
the reference's ``_infer_groups`` gives without one).  The three parts are
separate functions so the tests can hold each to the reference alone:

* :func:`route` — f32 router, softmax, top-k, and the capacity assignment
  (a token's slot in its expert is the running count of earlier claims);
  claims over capacity go to a trash column and are dropped;
* :func:`expert_ffn` — gather each expert's slots and run the GLU over them:
  the three products are kernel B5 (``repro_torch::moe_gmm``) launches;
* :func:`combine` — every token pulls its kept slots' outputs, weighted by
  their renormalised gates, summed in f32.

Capacity couples the tokens of one call: every row of a decode batch (idle
slots included), of a prompt and of a padded prefill chunk competes for
the same slots, exactly as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import moe_gmm

__all__ = ["capacity_for", "combine", "expert_ffn", "init_moe_params", "moe_ffn", "route"]


def init_moe_params(d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype, *,
                    generator: torch.Generator, device: torch.device) -> dict:
    """The reference's shapes and scales, drawn from ``generator`` on
    ``device``: the router stays f32 inside a bf16 model."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    return {
        "router": normal((d_model, n_experts), s_in),
        "w_gate": normal((n_experts, d_model, d_ff), s_in).to(dtype),
        "w_up": normal((n_experts, d_model, d_ff), s_in).to(dtype),
        "w_down": normal((n_experts, d_ff, d_model), s_out).to(dtype),
    }


def capacity_for(tokens_per_group: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots per expert per group, as the reference computes it: Python's
    ``round`` (half to even), at least ``top_k``, and a multiple of 8 once
    a group holds 8 tokens or more."""
    capacity = max(top_k, int(round(tokens_per_group * top_k * capacity_factor / n_experts)))
    if tokens_per_group >= 8:
        capacity = -(-capacity // 8) * 8
    return capacity


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int, capacity: int) -> dict:
    """Routing of ``xg [G, Tg, D]`` over the experts of ``router [D, E]``.

    Returns ``gate_vals [G, Tg, k]`` (f32, renormalised), ``expert_idx [G,
    Tg, k]``, ``positions [G, Tg, k]`` (slot in the expert, ``capacity`` =
    dropped), ``keep [G, Tg, k]``, ``slot_tok [G, E, capacity + 1]`` (the
    token in each slot; unfilled slots hold token 0, the last column is the
    trash every dropped claim writes to) and the Switch load-balancing
    ``aux_loss``.

    The reference assigns slots rank by rank: every token's first choice in
    token order, then every token's second choice, and so on, a claim's
    slot being the number of earlier claims on its expert.  One cumulative
    count over the claims laid out in that order gives the same integers
    in a handful of ops instead of a dozen per rank (each op is a graph
    node the host runtime dispatches)."""
    G, Tg, _ = xg.shape
    E = router.shape[-1]
    dev = xg.device
    logits = torch.matmul(xg.float(), router.float())          # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # [G, Tg, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=1)                                      # [G, E]

    claims = expert_idx.transpose(1, 2).reshape(G, top_k * Tg)  # rank-major
    onehot = (claims[..., None] == torch.arange(E, device=dev)).to(torch.int64)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)  # [G, k*Tg]
    keep = pos < capacity
    pos = torch.where(keep, pos, capacity)
    g_iota = torch.arange(G, device=dev)[:, None].expand(G, top_k * Tg)
    tok = torch.arange(Tg, device=dev).repeat(top_k)[None].expand(G, top_k * Tg)
    # duplicate indices occur only in the trash column, which no one reads
    slot_tok = torch.zeros((G, E, capacity + 1), dtype=torch.int64, device=dev)
    slot_tok = slot_tok.index_put((g_iota, claims, pos), tok)

    frac = onehot.sum(1).float()                                # claims per expert
    aux_loss = E * torch.mean(torch.sum(me * (frac / (Tg * top_k)), dim=-1))
    return {"gate_vals": gate_vals, "expert_idx": expert_idx,
            "positions": pos.reshape(G, top_k, Tg).transpose(1, 2),
            "keep": keep.reshape(G, top_k, Tg).transpose(1, 2),
            "slot_tok": slot_tok, "aux_loss": aux_loss}


def _grouped_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("gecd,edf->gecf")`` as one B5 launch: the groups share the
    experts' weights, so they stack along the slot axis."""
    G, E, C, D = x.shape
    if G == 1:
        return moe_gmm(x[0], w)[None]
    y = moe_gmm(x.transpose(0, 1).reshape(E, G * C, D), w)
    return y.reshape(E, G, C, -1).transpose(0, 1)


def expert_ffn(params: dict, xg: torch.Tensor, slot_tok: torch.Tensor, capacity: int,
               act: str) -> torch.Tensor:
    """Each expert's GLU over its gathered slots: ``xg [G, Tg, D]`` ->
    ``y [G, E, C, D]`` in xg's dtype (three B5 products)."""
    G, _, D = xg.shape
    E = slot_tok.shape[1]
    src = slot_tok[:, :, :capacity].reshape(G, E * capacity)     # trash sliced off
    xin = xg[torch.arange(G, device=xg.device)[:, None], src].reshape(G, E, capacity, D)
    h = _grouped_gmm(xin, params["w_gate"])
    h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    u = _grouped_gmm(xin, params["w_up"])
    return _grouped_gmm(h * u, params["w_down"])


def combine(y: torch.Tensor, routing: dict) -> torch.Tensor:
    """Token t's output: the sum over its k claims, in rank order, of gate x
    its slot's output (zero where dropped), in f32.  ``y [G, E, C, D]`` ->
    ``[G, Tg, D]`` f32."""
    G, E, capacity, D = y.shape
    expert_idx = routing["expert_idx"]
    _, Tg, k = expert_idx.shape
    idx = expert_idx * capacity + torch.clamp(routing["positions"], max=capacity - 1)
    g_iota = torch.arange(G, device=y.device)[:, None]
    y_sel = y.reshape(G, E * capacity, D)[g_iota, idx.reshape(G, Tg * k)]
    w = (routing["gate_vals"] * routing["keep"]).float()        # [G, Tg, k]
    return (w[..., None] * y_sel.reshape(G, Tg, k, D).float()).sum(dim=2)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            act: str = "silu", n_groups: int | None = None):
    """``x [B, S, D]`` -> ``(out [B, S, D] in x's dtype, aux_loss)``."""
    B, S, D = x.shape
    T = B * S
    E = params["router"].shape[-1]
    G = n_groups or 1
    if T % G:
        raise ValueError(f"moe_ffn: {T} tokens do not split into {G} groups")
    Tg = T // G
    capacity = capacity_for(Tg, top_k, capacity_factor, E)
    xg = x.reshape(G, Tg, D)
    routing = route(params["router"], xg, top_k, capacity)
    y = expert_ffn(params, xg, routing["slot_tok"], capacity, act)
    out = combine(y, routing)
    return out.reshape(B, S, D).to(x.dtype), routing["aux_loss"]
