"""Model operations of one training step, the standard accounting: ``6 N
tokens`` for the products of the active parameters (each token's top-k
experts, the router, the head; the embedding lookup is no product), plus
causal attention at three times its forward.  The recompute of a
rematerialised layer is not counted.  Frozen here.
"""


def active_product_params(model: dict) -> int:
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    vp = -(-model["vocab_size"] // 256) * 256
    attn = d * hd * (H + 2 * Hkv) + H * hd * d
    E = model["n_experts"]
    ffn = (model["top_k"] * 3 * d * f + d * E) if E else 3 * d * f
    return L * (attn + ffn) + d * vp


def flops(model: dict, B: int, S: int) -> float:
    d, H = model["d_model"], model["n_heads"]
    hd = model.get("head_dim") or d // H
    w = model.get("sliding_window")
    p = S * (S + 1) // 2 if (w is None or w >= S) else w * (w + 1) // 2 + (S - w) * w
    attention = 12 * hd * H * B * p * model["n_layers"]
    return 6.0 * active_product_params(model) * B * S + attention
