"""Mixture-of-Experts FFN: grouped top-k routing with capacity-based gather
dispatch — the port of the JAX package's ``models/moe.py``.

Tokens are split into ``n_groups`` groups routed independently, each with
its own per-expert capacity; ``n_groups=None`` takes the mesh's
data-parallel extent when it divides the tokens (``_infer_groups``, one
group without a mesh), as the reference does.  On a DTensor ``x`` each
data shard routes its own group and each ``model`` rank runs its own
experts (``dist.kernel_rules.moe_ffn``).  :func:`moe_ffn` runs four
parts in turn, separate functions so the tests can hold each to the
reference alone:

* :func:`route` — f32 router, softmax, top-k, and the capacity assignment
  (a token's slot in its expert is the running count of earlier claims;
  on the card the hand-written kernel ``repro_torch::moe_route_slots``);
  claims over capacity go to a trash column and are dropped;
* :func:`dispatch` — gather each expert's slots;
* :func:`experts` — each expert's GLU over its slots: the three products
  are kernel B5 (``repro_torch::moe_gmm``) launches;
* :func:`combine` — every token pulls its kept slots' outputs, weighted by
  their renormalised gates, summed in f32.

With the recorder on (:mod:`repro_torch.core.trace`) :func:`moe_ffn` is
the spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (again in remat's recompute, marked ``recompute``), their
backward ``moe.combine.bwd``, ``moe.experts.bwd``, ``moe.dispatch.bwd``
and ``moe.route.bwd`` (opened and closed by gradient hooks registered in
the first forward), and the counters ``moe.claims`` (G k Tg), ``moe.slots``
(G E C), ``moe.kept`` (the kept claims, summed on the device) and
``moe.route_kernel`` / ``moe.route_plain`` (the calls whose slot assignment
took the kernel / the plain count), counted in the first forward and summed
over the layers.

Capacity couples the tokens of one call: every row of a decode batch (idle
slots included), of a prompt and of a padded prefill chunk competes for
the same slots, exactly as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.dist.sharding import is_dtensor, mesh_context
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_route import route_slots, route_slots_path
from repro_torch.models.layers import glu_ffn

__all__ = ["capacity_for", "combine", "dispatch", "experts", "init_moe_params", "moe_ffn",
           "route"]


def init_moe_params(d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype, *,
                    generator: torch.Generator, device: torch.device,
                    router_width: int | None = None, n_shared: int = 0,
                    router_bias: bool = False) -> dict:
    """The reference's shapes and scales, drawn from ``generator`` on
    ``device``: the router stays f32 inside a bf16 model.  The experts may
    be a share (``n_experts``) of the router's ``router_width``;
    ``n_shared`` shared experts are one GLU of width ``n_shared * d_ff``
    (``params["shared"]``); ``router_bias`` adds the sigmoid router's f32
    correction bias (``params["router_bias"]``), zero: the published models
    learn it outside the gradient, to balance the load."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    out = {
        "router": normal((d_model, router_width or n_experts), s_in),
        "w_gate": normal((n_experts, d_model, d_ff), s_in).to(dtype),
        "w_up": normal((n_experts, d_model, d_ff), s_in).to(dtype),
        "w_down": normal((n_experts, d_ff, d_model), s_out).to(dtype),
    }
    if n_shared:
        f_s = n_shared * d_ff
        out["shared"] = {"w_gate": normal((d_model, f_s), s_in).to(dtype),
                         "w_up": normal((d_model, f_s), s_in).to(dtype),
                         "w_down": normal((f_s, d_model), f_s ** -0.5).to(dtype)}
    if router_bias:
        out["router_bias"] = torch.zeros(router_width or n_experts, dtype=torch.float32,
                                         device=device)
    return out


def capacity_for(tokens_per_group: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots per expert per group, as the reference computes it: Python's
    ``round`` (half to even), at least ``top_k``, and a multiple of 8 once
    a group holds 8 tokens or more."""
    capacity = max(top_k, int(round(tokens_per_group * top_k * capacity_factor / n_experts)))
    if tokens_per_group >= 8:
        capacity = -(-capacity // 8) * 8
    return capacity


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int, capacity: int, *,
          scoring: str = "softmax", bias: torch.Tensor | None = None,
          scaling: float = 1.0) -> dict:
    """Routing of ``xg [G, Tg, D]`` over the experts of ``router [D, E]``.

    Returns ``gate_vals [G, Tg, k]`` (f32, renormalised), ``expert_idx [G,
    Tg, k]``, ``positions [G, Tg, k]`` (slot in the expert, ``capacity`` =
    dropped), ``keep [G, Tg, k]``, ``slot_tok [G, E, capacity + 1]`` (the
    token in each slot; unfilled slots hold token 0, the last column is the
    trash every dropped claim writes to) and the Switch load-balancing
    ``aux_loss``.

    ``scoring="sigmoid"`` (DeepSeek-V3's ``noaux_tc`` with one group):
    scores are the logits' sigmoids, the experts the top-k of ``scores -
    mean + bias``, ``mean`` each expert's mean score over the group's
    tokens (the balanced load a trained correction bias gives; random
    weights route most tokens alike without it) and the f32 ``bias [E]``
    the correction (both enter the choice alone, so the bias gets no
    gradient), the gates the chosen scores renormalised and multiplied by
    ``scaling``; no load-balancing loss (``aux_loss`` 0.0).

    The reference assigns slots rank by rank: every token's first choice in
    token order, then every token's second choice, and so on, a claim's
    slot being the number of earlier claims on its expert.  One op,
    ``repro_torch::moe_route_slots`` (``kernels/moe_route``), gives the same
    integers for all ranks at once: on the card one hand-written kernel, on
    the CPU one cumulative count over the claims laid out in that order."""
    G, Tg, _ = xg.shape
    E = router.shape[-1]
    logits = torch.matmul(xg.float(), router.float())          # [G, Tg, E]
    if scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        choice = probs.detach()
        choice = choice - choice.mean(dim=1, keepdim=True)
        if bias is not None:
            choice = choice + bias.detach().float()
        expert_idx = torch.topk(choice, top_k, dim=-1)[1]       # [G, Tg, k]
        gate_vals = torch.gather(probs, -1, expert_idx)
    elif scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # [G, Tg, k]
    else:
        raise ValueError(f"route: unknown scoring {scoring!r}")
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    if scaling != 1.0:
        gate_vals = gate_vals * scaling
    me = probs.mean(dim=1) if scoring == "softmax" else None    # [G, E]

    positions, keep, slot_tok, counts = route_slots(expert_idx, E, capacity)
    aux_loss = 0.0
    if me is not None:
        frac = counts.float()                                   # claims per expert
        aux_loss = E * torch.mean(torch.sum(me * (frac / (Tg * top_k)), dim=-1))
    return {"gate_vals": gate_vals, "expert_idx": expert_idx, "positions": positions,
            "keep": keep, "slot_tok": slot_tok, "aux_loss": aux_loss}


def _grouped_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("gecd,edf->gecf")`` as one B5 launch: the groups share the
    experts' weights, so they stack along the slot axis."""
    G, E, C, D = x.shape
    if G == 1:
        return moe_gmm(x[0], w)[None]
    y = moe_gmm(x.transpose(0, 1).reshape(E, G * C, D), w)
    return y.reshape(E, G, C, -1).transpose(0, 1)


def dispatch(xg: torch.Tensor, slot_tok: torch.Tensor, capacity: int) -> torch.Tensor:
    """Each expert's slots gathered from ``xg [G, Tg, D]``: ``[G, E, C, D]``."""
    G, _, D = xg.shape
    E = slot_tok.shape[1]
    src = slot_tok[:, :, :capacity].reshape(G, E * capacity)     # trash sliced off
    return xg[torch.arange(G, device=xg.device)[:, None], src].reshape(G, E, capacity, D)


def experts(params: dict, xin: torch.Tensor, act: str) -> torch.Tensor:
    """Each expert's GLU over its slots: ``xin [G, E, C, D]`` -> ``y [G,
    E, C, D]`` in xin's dtype (three B5 products)."""
    h = _grouped_gmm(xin, params["w_gate"])
    h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    u = _grouped_gmm(xin, params["w_up"])
    return _grouped_gmm(h * u, params["w_down"])


def combine(y: torch.Tensor, routing: dict, first_expert: int = 0) -> torch.Tensor:
    """Token t's output: the sum over its k claims, in rank order, of gate x
    its slot's output (zero where dropped), in f32.  ``y [G, E, C, D]`` ->
    ``[G, Tg, D]`` f32.  ``y`` may hold only experts ``first_expert ..
    first_expert + E - 1`` (a rank's share): claims on other experts then
    add nothing."""
    G, E, capacity, D = y.shape
    expert_idx = routing["expert_idx"]
    _, Tg, k = expert_idx.shape
    keep = routing["keep"]
    n_all = routing["slot_tok"].shape[1]
    if E != n_all:
        mine = (expert_idx >= first_expert) & (expert_idx < first_expert + E)
        keep = keep & mine
        expert_idx = torch.clamp(expert_idx - first_expert, 0, E - 1)
    idx = expert_idx * capacity + torch.clamp(routing["positions"], max=capacity - 1)
    if E != n_all:
        # most of a share's claims add nothing here (other experts' or
        # dropped): they read rows spread over the share's slots, so that
        # their zero gradients do not pile into one row of the gather's
        # backward, which sums a row's duplicates one after another
        spread = torch.arange(Tg * k, device=y.device).reshape(Tg, k) % (E * capacity)
        idx = torch.where(keep, idx, spread)
    g_iota = torch.arange(G, device=y.device)[:, None]
    y_sel = y.reshape(G, E * capacity, D)[g_iota, idx.reshape(G, Tg * k)]
    w = (routing["gate_vals"] * keep).float()                   # [G, Tg, k]
    return (w[..., None] * y_sel.reshape(G, Tg, k, D).float()).sum(dim=2)


def _share_slots(routing: dict, slot_tok: torch.Tensor, first: int, e_l: int, capacity: int,
                 Tg: int) -> torch.Tensor:
    """The slots of experts ``first .. first + e_l - 1``, ``[G, e_l, capacity
    + 1]``, their unfilled slots reading tokens spread over the group in
    place of token 0: no claim reads an unfilled slot's output, so its
    gradient is zero, but the dispatch gather's backward sums a row's
    duplicates one after another, and a share leaves most of its slots
    unfilled.  A slot is filled where its position is under the kept
    claims on its expert."""
    idx, keep = routing["expert_idx"], routing["keep"]
    held = torch.arange(first, first + e_l, device=idx.device)
    kept = ((idx[..., None] == held) & keep[..., None]).sum(dim=(1, 2))     # [G, e_l]
    filled = torch.arange(capacity, device=idx.device) < kept[..., None]   # [G, e_l, C]
    spread = (torch.arange(e_l * capacity, device=idx.device) % Tg).reshape(e_l, capacity)
    share = slot_tok[:, first:first + e_l]
    return torch.cat([torch.where(filled, share[..., :capacity], spread),
                      share[..., capacity:]], dim=-1)


def _infer_groups(T: int) -> int:
    """Groups = data-parallel extent when it divides the tokens (each group
    lives on one data shard); 1 otherwise (and without a mesh)."""
    ctx = mesh_context()
    if ctx is None:
        return 1
    dp = ctx.extent(ctx.resolve("batch"))
    return dp if dp > 1 and T % dp == 0 else 1


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            act: str = "silu", n_groups: int | None = None, first_expert: int = 0,
            scoring: str = "softmax", scaling: float = 1.0):
    """``x [B, S, D]`` -> ``(out [B, S, D] in x's dtype, aux_loss)``.

    ``params``' expert weights may hold a share of the experts, from
    ``first_expert`` (a ``model`` rank's, or one card's share of an
    expert-parallel deployment): routing is over all of them (the router
    is whole) and the output sums only the share's slots.  ``scoring``,
    ``scaling`` and ``params["router_bias"]`` are :func:`route`'s; the
    shared experts (``params["shared"]``, a GLU on every token) add to the
    routed sum in f32, before the one rounding to x's dtype."""
    B, S, D = x.shape
    T = B * S
    G = n_groups or _infer_groups(T)
    if is_dtensor(x):
        if scoring != "softmax" or "shared" in params:
            raise NotImplementedError("moe_ffn: sigmoid routing and shared experts run on one "
                                      "device only")
        from repro_torch.dist import kernel_rules

        with trace.quiet():
            return kernel_rules.moe_ffn(moe_ffn, params, x, n_groups=G, top_k=top_k,
                                        capacity_factor=capacity_factor, act=act)
    E = params["router"].shape[-1]
    if T % G:
        raise ValueError(f"moe_ffn: {T} tokens do not split into {G} groups")
    Tg = T // G
    capacity = capacity_for(Tg, top_k, capacity_factor, E)
    xg = x.reshape(G, Tg, D)
    rec = trace.live(x)
    # remat's recompute runs inside the backward's graph task
    attrs = {"recompute": True} if rec and torch._C._current_graph_task_id() != -1 else {}
    hooks = rec and not attrs and x.requires_grad and torch.is_grad_enabled()
    # with hooks, route and dispatch read views of their own, whose gradients
    # close their backward spans; dispatch's view comes after route's ops, so
    # that its backward runs first
    xr = xg.view_as(xg) if hooks else xg
    with trace.span("moe.route", **attrs):
        routing = route(params["router"], xr, top_k, capacity, scoring=scoring,
                        bias=params.get("router_bias"), scaling=scaling)
    xd = xg.view_as(xg) if hooks else xg
    e_l = params["w_gate"].shape[0]
    if rec and not attrs:
        trace.count("moe.claims", G * top_k * Tg)
        trace.count("moe.slots", G * E * capacity)
        kernel = route_slots_path(routing["expert_idx"]) == "kernel"
        trace.count("moe.route_kernel", int(kernel))
        trace.count("moe.route_plain", int(not kernel))
        trace.accumulate("moe.kept", routing["keep"].sum())
        if e_l != E:
            idx = routing["expert_idx"]
            held = (idx >= first_expert) & (idx < first_expert + e_l)
            trace.accumulate("moe.held", (routing["keep"] & held).sum())
    slot_tok = routing["slot_tok"]
    if e_l != E:
        slot_tok = _share_slots(routing, slot_tok, first_expert, e_l, capacity, Tg)
    with trace.span("moe.dispatch", **attrs):
        xin = dispatch(xd, slot_tok, capacity)
    with trace.span("moe.experts", **attrs):
        y = experts(params, xin, act)
    with trace.span("moe.combine", **attrs):
        out = combine(y, routing, first_expert)
    if hooks:
        trace.backward_spans([out, y, xin, xd, xr], ["moe.combine.bwd", "moe.experts.bwd",
                                                     "moe.dispatch.bwd", "moe.route.bwd"])
    out = out.reshape(B, S, D)
    if "shared" in params:
        sp = params["shared"]
        xs = x.view_as(x) if hooks else x
        with trace.span("moe.shared", **attrs):
            sh = glu_ffn(xs, sp["w_gate"], sp["w_up"], sp["w_down"], act)
        if hooks:
            trace.backward_spans([sh, xs], ["moe.shared.bwd"])
        out = out + sh.float()
    return out.to(x.dtype), routing["aux_loss"]
