"""Plain float32 reference of a DeepSeek-V3-style decoder as the port trains
it: latent attention (MLA), leading dense layers, then mixture-of-experts
layers with sigmoid routing, a choice-only correction bias, shared experts
and one card's share of the routed experts.  Embedding, RMSNorm with a
``1 + w`` gain, a final norm, an untied head over the padded vocabulary,
mean next-token cross-entropy (no load-balancing loss).

Written from the model's equations with plain ``torch`` operations; it
imports nothing of the program.  Per layer:

* MLA: ``q = h Wq`` (per head ``[nope | rope]``); the latent ``[c | k_pe] =
  h Wkv_a``; ``c`` RMS-normed and projected up, ``[k_nope | v] = norm(c)
  Wkv_b`` per head; rope on ``q_pe`` and on the one ``k_pe`` all heads
  share (the two halves of the rope dims rotated together); ``k = [k_nope
  | k_pe]``; causal softmax attention with scale ``(nope + rope)^-0.5``;
  the heads' ``v``-wide outputs through ``Wo``;
* a dense layer: a SwiGLU FFN of width ``dense_d_ff``;
* a MoE layer: scores ``sigmoid(h Wr)`` over all ``n_routed_experts``; each
  token's experts the top-k of ``scores - mean + bias``, ``mean`` each
  expert's mean score over the batch's tokens (the load a trained bias
  balances; the bias starts at zero); gates the chosen scores
  renormalised, times ``routed_scaling``; a claim's slot is the number of
  earlier claims on its expert, claims taken rank by rank (every token's
  first choice in token order, then every second, ...), kept while its
  expert has one of its ``capacity`` slots (1.25 x the even share over all
  routed experts, rounded half to even, a multiple of 8); the held experts
  ``0 .. n_experts - 1`` compute their kept claims' SwiGLU outputs, which
  each token sums weighted by its gates; the claims on the other experts
  add nothing (they are the other cards' part); the shared experts, one
  SwiGLU of width ``n_shared_experts * d_ff``, add on every token.

The departures from the published model are the configuration's
(``departures`` in its file).  Every product runs in float32 with TF32 off.
``precision="fp8"`` is the control: every product one precision below the
configuration's, forward and backward.  The bfloat16 products (the linear
layers, the head, attention's q, k and v) take operands rounded to float8
e4m3 with one scale per tensor; the float32 router takes bfloat16 operands.

The loss and its gradients are computed layer by layer: a forward pass
keeps each layer's input, and the backward pass recomputes one layer at a
time.  Attention runs in blocks of query rows with its own backward, so no
``[S, S]`` score matrix for all heads is held.
"""
from __future__ import annotations

import math

import torch

IGNORE = -1
_Q_BLOCK = 256
_HEAD_ROWS = 2048
_FP8_MAX = 448.0
_NO_DECAY = ("ln1", "ln2", "ln_kv", "final_norm", "router_bias")


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // 256) * 256


def _moe_layer(model: dict, i: int) -> bool:
    return bool(model["n_experts"]) and i >= model["first_dense_layers"]


def layout(model: dict) -> list[tuple[tuple, tuple, str, tuple]]:
    """Every parameter as ``(path, shape, dtype, init)`` in the program's
    tree; ``init`` is ``("normal", std)`` or ``("zeros",)``.  The norms'
    gains are zero (the gain is ``1 + w``); the router and its bias are
    float32, the bias zero (``assumed`` in the configuration's file)."""
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    H, r = model["n_heads"], model["kv_lora_rank"]
    nope, rope, dv = model["qk_nope_head_dim"], model["qk_rope_head_dim"], model["v_head_dim"]
    V, wdt = padded_vocab(model), model["dtype"]
    E, Er = model["n_experts"], model["n_routed_experts"]
    fs, fd = model["n_shared_experts"] * f, model["dense_d_ff"]
    out = [(("embed",), (V, d), wdt, ("normal", d ** -0.5)),
           (("final_norm",), (d,), wdt, ("zeros",)),
           (("unembed",), (d, V), wdt, ("normal", d ** -0.5))]
    for i in range(L):
        p = ("layers", i)
        out += [(p + ("ln1",), (d,), wdt, ("zeros",)),
                (p + ("attn", "wq"), (d, H * (nope + rope)), wdt, ("normal", d ** -0.5)),
                (p + ("attn", "wkv_a"), (d, r + rope), wdt, ("normal", d ** -0.5)),
                (p + ("attn", "ln_kv"), (r,), wdt, ("zeros",)),
                (p + ("attn", "wkv_b"), (r, H * (nope + dv)), wdt, ("normal", r ** -0.5)),
                (p + ("attn", "wo"), (H * dv, d), wdt, ("normal", (H * dv) ** -0.5)),
                (p + ("ln2",), (d,), wdt, ("zeros",))]
        if _moe_layer(model, i):
            out += [(p + ("mlp", "router"), (d, Er), "float32", ("normal", d ** -0.5)),
                    (p + ("mlp", "w_gate"), (E, d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_up"), (E, d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_down"), (E, f, d), wdt, ("normal", f ** -0.5)),
                    (p + ("mlp", "shared", "w_gate"), (d, fs), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "shared", "w_up"), (d, fs), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "shared", "w_down"), (fs, d), wdt, ("normal", fs ** -0.5)),
                    (p + ("mlp", "router_bias"), (Er,), "float32", ("zeros",))]
        else:
            out += [(p + ("mlp", "w_gate"), (d, fd), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_up"), (d, fd), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_down"), (fd, d), wdt, ("normal", fd ** -0.5))]
    return out


def decays(path: tuple) -> bool:
    """Weight decay applies to the matrices, not to the norms' gains or the
    router's bias."""
    return path[-1] not in _NO_DECAY


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = _FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_fp8(a), _fp8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8, a8, b8 = _fp8(g), _fp8(a), _fp8(b)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        if gb.dim() > b.dim():             # a batched over rows, b shared
            gb = gb.reshape(-1, *b.shape).sum(0)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return torch.matmul(a, b)


class _Fp8Round(torch.autograd.Function):
    """An operand rounded to float8 e4m3 on the way in, its gradient on the
    way back."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def router_mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """The router's float32 product; bfloat16 operands in the control."""
    if precision == "fp8":
        return torch.matmul(x.bfloat16().float(), w.bfloat16().float())
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, n]: rotate the two halves of the n rope dims by position."""
    S, n = x.shape[1], x.shape[-1]
    half = n // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _visible(q0: int, q1: int, device) -> torch.Tensor:
    qp = torch.arange(q0, q1, device=device)[:, None]
    kp = torch.arange(q1, device=device)[None, :]
    return kp <= qp


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(q's width)) v over q, k [B, H, S, n], v [B, H,
    S, dv], causal, in blocks of query rows; the backward recomputes each
    block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, H, S, n = q.shape
        scale = n ** -0.5
        out = q.new_empty((B, H, S, v.shape[-1]))
        lse = torch.empty((B, H, S), dtype=q.dtype, device=q.device)
        for q0 in range(0, S, _Q_BLOCK):
            q1 = min(q0 + _Q_BLOCK, S)
            s = torch.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
            s = s.masked_fill(~_visible(q0, q1, q.device), float("-inf"))
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(-1, keepdim=True)
            out[:, :, q0:q1] = torch.matmul(p / den, v[:, :, :q1])
            lse[:, :, q0:q1] = (m + torch.log(den))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, H, S, n = q.shape
        scale = n ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        D = (dout * out).sum(-1, keepdim=True)
        for q0 in range(0, S, _Q_BLOCK):
            q1 = min(q0 + _Q_BLOCK, S)
            s = torch.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
            s = s.masked_fill(~_visible(q0, q1, q.device), float("-inf"))
            p = torch.exp(s - lse[:, :, q0:q1, None])
            do = dout[:, :, q0:q1]
            dv[:, :, :q1] += torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, v[:, :, :q1].transpose(-1, -2)) - D[:, :, q0:q1])
            dq[:, :, q0:q1] = torch.matmul(ds, k[:, :, :q1]) * scale
            dk[:, :, :q1] += torch.matmul(ds.transpose(-1, -2), q[:, :, q0:q1]) * scale
        return dq, dk, dv


def attention(model: dict, lp: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    """Latent attention (the module's docstring)."""
    B, S, d = h.shape
    H, r = model["n_heads"], model["kv_lora_rank"]
    nope, nr, dv = model["qk_nope_head_dim"], model["qk_rope_head_dim"], model["v_head_dim"]
    theta = model["rope_theta"]
    q = mm(h, lp["attn.wq"], precision).reshape(B, S, H, nope + nr)
    latent = mm(h, lp["attn.wkv_a"], precision)
    c = rms_norm(latent[..., :r], lp["attn.ln_kv"], model["norm_eps"])
    kv = mm(c, lp["attn.wkv_b"], precision).reshape(B, S, H, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k_pe = rope(latent[:, :, None, r:], theta).expand(B, S, H, nr)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    if precision == "fp8":
        q, k, v = _Fp8Round.apply(q), _Fp8Round.apply(k), _Fp8Round.apply(v)
    o = _Attention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return mm(o.transpose(1, 2).reshape(B, S, H * dv), lp["attn.wo"], precision)


def capacity(tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    """Slots per expert: round half to even, at least top_k, a multiple of 8
    once 8 tokens or more are routed."""
    c = max(top_k, int(round(tokens * top_k * factor / n_experts)))
    if tokens >= 8:
        c = -(-c // 8) * 8
    return c


def glu(w_gate, w_up, w_down, h: torch.Tensor, precision: str) -> torch.Tensor:
    a = mm(h, w_gate, precision)
    u = mm(h, w_up, precision)
    return mm(torch.nn.functional.silu(a) * u, w_down, precision)


def experts(model: dict, lp: dict, h: torch.Tensor, precision: str):
    """The MoE layer's output on this card (the held experts' part and the
    shared experts) and the number of kept claims on the held experts."""
    B, S, d = h.shape
    E, Er, k = model["n_experts"], model["n_routed_experts"], model["top_k"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    scores = torch.sigmoid(router_mm(x, lp["mlp.router"], precision))           # [T, Er]
    choice = scores.detach() - scores.detach().mean(0)
    idx = torch.topk(choice + lp["mlp.router_bias"].detach(), k, dim=-1).indices
    gates = scores.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9) * model["routed_scaling"]
    claims = idx.t().reshape(-1)                                                # rank-major
    onehot = torch.nn.functional.one_hot(claims, Er)
    slot = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    keep = slot < capacity(T, k, model["capacity_factor"], Er)
    tok = torch.arange(T, device=x.device).repeat(k)
    rank = torch.arange(k, device=x.device).repeat_interleave(T)
    out = torch.zeros_like(x)
    held = 0
    for e in range(E):
        sel = keep & (claims == e)
        n = int(sel.sum())
        if not n:
            continue
        held += n
        t, r = tok[sel], rank[sel]
        y = glu(lp["mlp.w_gate"][e], lp["mlp.w_up"][e], lp["mlp.w_down"][e], x[t], precision)
        out = out.index_add(0, t, gates[t, r][:, None] * y)
    out = out + glu(lp["mlp.shared.w_gate"], lp["mlp.shared.w_up"], lp["mlp.shared.w_down"], x,
                    precision)
    return out.reshape(B, S, d), held


def block(model: dict, lp: dict, x: torch.Tensor, i: int, precision: str):
    """Layer i: ``(x_out, kept)``, ``kept`` None for a dense layer."""
    eps = model["norm_eps"]
    x = x + attention(model, lp, rms_norm(x, lp["ln1"], eps), precision)
    h = rms_norm(x, lp["ln2"], eps)
    if _moe_layer(model, i):
        y, kept = experts(model, lp, h, precision)
        return x + y, kept
    return x + glu(lp["mlp.w_gate"], lp["mlp.w_up"], lp["mlp.w_down"], h, precision), None


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _layer_params(params: dict, i: int, grad: bool) -> dict:
    """Layer i's leaves in float32, keyed ``"attn.wq"``, ``"ln1"``, ..."""
    out = {}
    for path, t in params.items():
        if len(path) > 2 and path[0] == "layers" and path[1] == i:
            out[".".join(path[2:])] = t.float().requires_grad_(grad)
    return out


def loss_and_grads(model: dict, params: dict, batch: dict, precision: str = "fp32",
                   keep: dict | None = None):
    """The loss of one batch and the gradient of every leaf.

    ``params`` maps each ``layout`` path to its tensor (any float dtype);
    ``batch`` holds ``tokens`` and ``labels`` [B, S].  Returns ``(loss,
    grads, kept)``: the loss as a float, float32 gradients by path (zero for
    the router's bias, which enters only the choice), and the kept claims
    on the held experts of each MoE layer.  ``keep`` receives the
    embedding's per-occurrence gradient (``embed_dx``)."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    L, d = model["n_layers"], model["d_model"]
    grads = {}
    embed = params[("embed",)].float()
    x = embed[tokens]
    xs, kept_rows = [x], []
    with torch.no_grad():
        for i in range(L):
            x, k = block(model, _layer_params(params, i, False), x, i, precision)
            xs.append(x)
            if k is not None:
                kept_rows.append(k)

    # the head, in blocks of rows: mean cross-entropy over the labelled positions
    mask = (labels != IGNORE) & (labels < model["vocab_size"])
    count = max(int(mask.sum()), 1)
    w_head = params[("unembed",)].float().requires_grad_(True)
    w_norm = params[("final_norm",)].float().requires_grad_(True)
    xl = xs[-1].reshape(-1, d)
    flat_labels, flat_mask = labels.reshape(-1), mask.reshape(-1)
    dx = torch.zeros_like(xl)
    ce = 0.0
    for r0 in range(0, xl.shape[0], _HEAD_ROWS):
        xr = xl[r0:r0 + _HEAD_ROWS].detach().requires_grad_(True)
        logits = mm(rms_norm(xr, w_norm, model["norm_eps"]), w_head, precision)
        lab = torch.where(flat_mask[r0:r0 + _HEAD_ROWS], flat_labels[r0:r0 + _HEAD_ROWS], 0)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, lab[:, None])[:, 0]
        part = (nll * flat_mask[r0:r0 + _HEAD_ROWS]).sum() / count
        part.backward()
        ce += float(part.detach())
        dx[r0:r0 + _HEAD_ROWS] = xr.grad
    grads[("final_norm",)] = w_norm.grad
    grads[("unembed",)] = w_head.grad
    dx = dx.reshape(xs[-1].shape)

    # the layers, last to first, each recomputed with its gradient
    for i in reversed(range(L)):
        lp = _layer_params(params, i, True)
        xi = xs[i].detach().requires_grad_(True)
        y, _ = block(model, lp, xi, i, precision)
        (y * dx).sum().backward()
        dx = xi.grad
        for name, t in lp.items():
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            grads[("layers", i) + tuple(name.split("."))] = g
        xs[i + 1] = None

    if keep is not None:
        keep["embed_dx"] = dx
    grads[("embed",)] = torch.zeros_like(embed).index_add_(0, tokens.reshape(-1),
                                                           dx.reshape(-1, d))
    return ce, grads, kept_rows
