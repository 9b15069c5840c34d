"""The MoE slot assignment's test cases (``repro_torch::moe_route_slots``),
shared by the CPU tests (``test_torch_moe.py``, against the JAX package)
and the card tests (``test_torch_gpu.py``, the kernel against the plain
version).  No JAX here: the card's test process does not import it."""
import numpy as np
import torch

# (G, Tg, k, E, capacity, ids): granite's decode step (8 rows, top-8 of
# 32); its s512 and s4096 training rows (B x S tokens, one group);
# moonlight's (64 experts, top-6, C = 960); a 256-wide router, top-8; two
# and four groups; a capacity far below k Tg / E; every claim on one
# expert; Tg not a multiple of 32
SLOT_CASES = [
    (1, 8, 8, 32, 8, "distinct"),
    (1, 2048, 8, 32, 640, "skewed"),
    (1, 8192, 8, 32, 2560, "distinct"),
    (1, 8192, 6, 64, 960, "skewed"),
    (1, 1024, 8, 256, 40, "skewed"),
    (2, 300, 4, 16, 96, "skewed"),
    (4, 96, 2, 8, 32, "distinct"),
    (1, 1000, 4, 8, 16, "distinct"),
    (1, 200, 3, 8, 16, "one"),
    (3, 37, 8, 32, 16, "skewed"),
    (1, 333, 8, 32, 104, "distinct"),
]
SLOT_IDS = ["decode", "granite-s512", "granite-s4096", "moonlight", "e256", "g2", "g4",
            "capacity-far-below", "one-expert", "g3-ragged", "ragged"]


def slot_ids(G, Tg, k, E, how, seed):
    """``expert_idx [G, Tg, k]`` int64 on the CPU: ``"distinct"`` a token's k
    experts drawn without repeats, uniformly; ``"skewed"`` the same with
    weights ~1 / (e + 1), so the first experts overflow; ``"one"`` every
    claim on expert E // 2 (a token repeating it: the count takes any
    ids)."""
    rng = np.random.default_rng(seed)
    if how == "one":
        return torch.full((G, Tg, k), E // 2, dtype=torch.int64)
    w = np.ones(E) if how == "distinct" else 1.0 / np.arange(1, E + 1)
    keys = rng.random((G, Tg, E)) ** (1.0 / w)              # weighted draw without repeats
    return torch.from_numpy(np.argsort(-keys, axis=-1)[..., :k].copy())


def assert_trash(slot_tok, expert_idx, keep, counts, capacity):
    """The trash column: a dropped claim's token where its expert dropped
    one, else token 0 (tensors on any device)."""
    slot_tok, expert_idx, keep, counts = (t.cpu() for t in (slot_tok, expert_idx, keep, counts))
    G, E = counts.shape
    for g in range(G):
        dropped_on = {}
        for t, r in torch.nonzero(~keep[g]).tolist():
            dropped_on.setdefault(int(expert_idx[g, t, r]), set()).add(t)
        for e in range(E):
            got = int(slot_tok[g, e, capacity])
            if counts[g, e] > capacity:
                assert got in dropped_on.get(e, ()), (g, e, got)
            else:
                assert got == 0, (g, e, got)
