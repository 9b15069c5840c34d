"""Plain float32 reference of a decoder-only language model with a dense or
a mixture-of-experts FFN, as the port trains it: embedding, RMSNorm with a
``1 + w`` gain, rotary attention (GQA, causal, optional window), SwiGLU FFN
or top-k routed experts with per-expert capacity and drops, a final norm, an
untied (or tied) head over the padded vocabulary, mean next-token
cross-entropy plus 0.01 times the summed load-balancing loss.

Written from the model's equations with plain ``torch`` operations; it
imports nothing of the program.  It keeps the program's documented
semantics where they depart from the published model (``departures`` in
the configuration's file).  Every product runs in float32 with TF32 off.
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
AUX_WEIGHT = 0.01
_Q_BLOCK = 256
_HEAD_ROWS = 2048
_FP8_MAX = 448.0


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // 256) * 256


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def layout(model: dict) -> list[tuple[tuple, tuple, str, tuple]]:
    """Every parameter as ``(path, shape, dtype, init)`` in the program's
    tree (``params["layers"][i]["attn"]["wq"]`` is ``("layers", i, "attn",
    "wq")``); ``init`` is ``("normal", std)`` or ``("zeros",)``.  The norms'
    gains are zero (the gain is ``1 + w``); a router is float32."""
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    hd, H, Hkv, V = head_dim(model), model["n_heads"], model["n_kv_heads"], padded_vocab(model)
    wdt = model["dtype"]
    out = [(("embed",), (V, d), wdt, ("normal", d ** -0.5)),
           (("final_norm",), (d,), wdt, ("zeros",))]
    if not model["tie_embeddings"]:
        out.append((("unembed",), (d, V), wdt, ("normal", d ** -0.5)))
    for i in range(L):
        p = ("layers", i)
        out += [(p + ("ln1",), (d,), wdt, ("zeros",)),
                (p + ("attn", "wq"), (d, H * hd), wdt, ("normal", d ** -0.5)),
                (p + ("attn", "wk"), (d, Hkv * hd), wdt, ("normal", d ** -0.5)),
                (p + ("attn", "wv"), (d, Hkv * hd), wdt, ("normal", d ** -0.5)),
                (p + ("attn", "wo"), (H * hd, d), wdt, ("normal", (H * hd) ** -0.5)),
                (p + ("ln2",), (d,), wdt, ("zeros",))]
        E = model["n_experts"]
        if E:
            out += [(p + ("mlp", "router"), (d, E), "float32", ("normal", d ** -0.5)),
                    (p + ("mlp", "w_gate"), (E, d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_up"), (E, d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_down"), (E, f, d), wdt, ("normal", f ** -0.5))]
        else:
            out += [(p + ("mlp", "w_gate"), (d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_up"), (d, f), wdt, ("normal", d ** -0.5)),
                    (p + ("mlp", "w_down"), (f, d), wdt, ("normal", f ** -0.5))]
    return out


def decays(path: tuple) -> bool:
    """Weight decay applies to the matrices, not to the norms' gains."""
    return path[-1] not in ("ln1", "ln2", "final_norm")


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
    """x [B, S, H, hd]: rotate the two halves of each head by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _visible(q0: int, q1: int, S: int, window: int | None, device) -> torch.Tensor:
    qp = torch.arange(q0, q1, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    keep = kp <= qp
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(hd)) v over [B, H, S, hd] (k, v already one per
    query head), causal, in blocks of query rows; the backward recomputes
    each block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        B, H, S, hd = q.shape
        scale = hd ** -0.5
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=q.dtype, device=q.device)
        for q0 in range(0, S, _Q_BLOCK):
            q1 = min(q0 + _Q_BLOCK, S)
            s = torch.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
            s = s.masked_fill(~_visible(q0, q1, q1, window, q.device), float("-inf"))
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(-1, keepdim=True)
            out[:, :, q0:q1] = torch.matmul(p / den, v[:, :, :q1])
            lse[:, :, q0:q1] = (m + torch.log(den))[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, H, S, hd = q.shape
        scale = hd ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        D = (dout * out).sum(-1, keepdim=True)
        for q0 in range(0, S, _Q_BLOCK):
            q1 = min(q0 + _Q_BLOCK, S)
            s = torch.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
            s = s.masked_fill(~_visible(q0, q1, q1, ctx.window, q.device), float("-inf"))
            p = torch.exp(s - lse[:, :, q0:q1, None])
            do = dout[:, :, q0:q1]
            dv[:, :, :q1] += torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, v[:, :, :q1].transpose(-1, -2)) - D[:, :, q0:q1])
            dq[:, :, q0:q1] = torch.matmul(ds, k[:, :, :q1]) * scale
            dk[:, :, :q1] += torch.matmul(ds.transpose(-1, -2), q[:, :, q0:q1]) * scale
        return dq, dk, dv, None


def attention(model: dict, lp: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, d = h.shape
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], head_dim(model)
    q = mm(h, lp["attn.wq"], precision).reshape(B, S, H, hd)
    k = mm(h, lp["attn.wk"], precision).reshape(B, S, Hkv, hd)
    v = mm(h, lp["attn.wv"], precision).reshape(B, S, Hkv, hd)
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    if precision == "fp8":
        q, k, v = _Fp8Round.apply(q), _Fp8Round.apply(k), _Fp8Round.apply(v)
    G = H // Hkv                          # query head j reads kv head j // G
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(G, dim=1)
    v = v.transpose(1, 2).repeat_interleave(G, dim=1)
    o = _Attention.apply(q, k, v, model["sliding_window"])
    return mm(o.transpose(1, 2).reshape(B, S, H * hd), lp["attn.wo"], precision)


def capacity(tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    """Slots per expert: round half to even, at least top_k, a multiple of 8
    once 8 tokens or more are routed."""
    c = max(top_k, int(round(tokens * top_k * factor / n_experts)))
    if tokens >= 8:
        c = -(-c // 8) * 8
    return c


def experts(model: dict, lp: dict, h: torch.Tensor, precision: str):
    """Top-k routing over all experts, claims taken rank by rank (every
    token's first choice in token order, then every second choice, ...),
    a claim kept while its expert has a free slot; each token sums its kept
    claims' SwiGLU outputs weighted by its renormalised gates.  Returns the
    output, the Switch load-balancing loss and the number of kept claims."""
    B, S, d = h.shape
    E, k = model["n_experts"], model["top_k"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    probs = torch.softmax(router_mm(x, lp["mlp.router"], precision), dim=-1)  # [T, E]
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    claims = idx.detach().t().reshape(-1)                                   # rank-major
    onehot = torch.nn.functional.one_hot(claims, E)
    slot = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    keep = slot < capacity(T, k, model["capacity_factor"], E)
    tok = torch.arange(T, device=x.device).repeat(k)
    rank = torch.arange(k, device=x.device).repeat_interleave(T)
    out = torch.zeros_like(x)
    for e in range(E):
        sel = keep & (claims == e)
        if not bool(sel.any()):
            continue
        t, r = tok[sel], rank[sel]
        xe = x[t]
        a = mm(xe, lp["mlp.w_gate"][e], precision)
        u = mm(xe, lp["mlp.w_up"][e], precision)
        y = mm(torch.nn.functional.silu(a) * u, lp["mlp.w_down"][e], precision)
        out = out.index_add(0, t, gates[t, r][:, None] * y)
    frac = onehot.sum(0).float() / (T * k)
    aux = E * torch.sum(probs.mean(0) * frac)
    return out.reshape(B, S, d), aux, int(keep.sum())


def glu(lp: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    a = mm(h, lp["mlp.w_gate"], precision)
    u = mm(h, lp["mlp.w_up"], precision)
    return mm(torch.nn.functional.silu(a) * u, lp["mlp.w_down"], precision)


def block(model: dict, lp: dict, x: torch.Tensor, precision: str):
    """One layer: ``(x_out, aux, kept)``."""
    eps = model["norm_eps"]
    x = x + attention(model, lp, rms_norm(x, lp["ln1"], eps), precision)
    h = rms_norm(x, lp["ln2"], eps)
    if model["n_experts"]:
        y, aux, kept = experts(model, lp, h, precision)
        return x + y, aux, kept
    return x + glu(lp, h, precision), None, 0


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
    grads, kept)``: the loss as a float, float32 gradients by path, and the
    kept claims of each MoE layer (empty without experts)."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    L, d = model["n_layers"], model["d_model"]
    tied = model["tie_embeddings"]
    grads = {}
    embed = params[("embed",)].float()
    x = embed[tokens]
    if tied:
        x = x * math.sqrt(d)
    xs, kept = [x], []
    aux_total = 0.0
    with torch.no_grad():
        for i in range(L):
            x, aux, k = block(model, _layer_params(params, i, False), x, precision)
            xs.append(x)
            if aux is not None:
                aux_total += float(aux)
                kept.append(k)

    # the head, in blocks of rows: mean cross-entropy over the labelled positions
    mask = (labels != IGNORE) & (labels < model["vocab_size"])
    count = max(int(mask.sum()), 1)
    w_head = (embed.t() if tied else params[("unembed",)].float()).requires_grad_(True)
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
    head_grad = w_head.grad
    dx = dx.reshape(xs[-1].shape)

    # the layers, last to first, each recomputed with its gradient
    for i in reversed(range(L)):
        lp = _layer_params(params, i, True)
        xi = xs[i].detach().requires_grad_(True)
        y, aux, _ = block(model, lp, xi, precision)
        obj = (y * dx).sum()
        if aux is not None:
            obj = obj + AUX_WEIGHT * aux
        obj.backward()
        dx = xi.grad
        for name, t in lp.items():
            grads[("layers", i) + tuple(name.split("."))] = t.grad
        xs[i + 1] = None

    if tied:
        dx = dx * math.sqrt(d)
    if keep is not None:
        keep["embed_dx"] = dx
    g_embed = torch.zeros_like(embed).index_add_(0, tokens.reshape(-1), dx.reshape(-1, d))
    if tied:
        g_embed += head_grad.t()
    else:
        grads[("unembed",)] = head_grad
    grads[("embed",)] = g_embed
    return ce + AUX_WEIGHT * aux_total, grads, kept
