"""The frozen roofline formulas against hand counts at small shapes."""
import itertools

from harness import spec


def _visible_pairs(S, window):
    return sum(1 for q, k in itertools.product(range(S), repeat=2)
               if k <= q and (window is None or k > q - window))


def test_attention_counts_visible_pairs_by_hand():
    att = spec.roofline("attention")
    for S, w in ((4, None), (7, 3), (5, 5), (6, 100)):
        assert att.pairs(S, w) == _visible_pairs(S, w)
    B, S, Hq, Hkv, hd = 2, 4, 4, 2, 8
    flops, nbytes = att.forward(B, S, Hq, Hkv, hd, None, 2)
    assert flops == 4 * hd * Hq * B * 10          # Q K^T and P V over 10 pairs a head
    q = o = B * S * Hq * hd * 2
    k = v = B * S * Hkv * hd * 2
    assert nbytes == q + k + v + o + 4 * B * Hq * S
    flops, nbytes = att.backward(B, S, Hq, Hkv, hd, None, 2)
    assert flops == 10 * hd * Hq * B * 10
    assert nbytes == (q + k + v + o + q) + 4 * B * Hq * S + (q + k + v)


def test_moe_gmm_counts_kept_rows_by_hand():
    gmm = spec.roofline("moe_gmm")
    rows, E, D, F = 3, 2, 4, 5
    assert gmm.forward(rows, E, D, F, 2) == (2 * 3 * 4 * 5, 2 * (3 * 4 + 2 * 4 * 5 + 3 * 5))
    flops, nbytes = gmm.backward(rows, E, D, F, 2)
    assert flops == 2 * (2 * 3 * 4 * 5)            # dX and dW
    assert nbytes == 2 * (3 * 4 + 2 * 4 * 5 + 3 * 5 + 3 * 4 + 2 * 4 * 5)


def test_train_step_flops_by_hand():
    ts = spec.roofline("train_step")
    dense = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
             "d_ff": 16, "vocab_size": 300, "n_experts": 0, "top_k": 0, "sliding_window": None}
    attn = 8 * 4 * (2 + 2) + 2 * 4 * 8          # wq, wk, wv; wo
    ffn = 3 * 8 * 16
    head = 8 * 512                               # the vocabulary padded to 512
    assert ts.active_product_params(dense) == 2 * (attn + ffn) + head
    B, S = 3, 5
    att = 12 * 4 * 2 * B * 15 * 2                # 15 causal pairs a head, 2 layers
    assert ts.flops(dense, B, S) == 6.0 * (2 * (attn + ffn) + head) * B * S + att
    moe = dict(dense, n_experts=4, top_k=2)
    assert ts.active_product_params(moe) == 2 * (attn + 2 * ffn + 8 * 4) + head
