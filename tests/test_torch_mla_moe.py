"""moonlight-16b-a3b (the DeepSeek-V3 block) in the port, on the CPU: the
training path held to the benchmark's plain float32 reference
(``bench/reference/mla_moe.py``, loaded by its path) on seeded random weights at the
SMOKE size, loss and every leaf's gradient; a float8 or half-batch fault
fails that comparison; the card's share of a layer's experts ties to the
uncut layer; the sigmoid router's bias moves choices and not gates; B3's
plain path at latent attention's widths; the embedding's gradient summed
in f32; the spans and the ``moe.held`` counter; the parameter count; the
serving entry points refuse the arch."""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.core import trace
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain, flash_attention_train)
from repro_torch.models import api as model_api
from repro_torch.models import moe, transformer
from repro_torch.train.step import (TrainStepConfig, init_train_state, make_train_step,
                                    param_specs, value_and_grad)

ARCH = "moonlight-16b-a3b"
ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "bench_reference_mla_moe", ROOT / "bench" / "reference" / "mla_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()
# the model keys of bench/configs/moonlight-16b-a3b.json, read off a port config
_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "rope_theta",
         "norm_eps", "n_experts", "n_routed_experts", "top_k", "capacity_factor",
         "n_shared_experts", "routed_scaling", "first_dense_layers", "dense_d_ff",
         "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")
# the port in f32 against the f32 reference: the same sums in another order
# (B3's plain online softmax against the reference's blocked softmax, the
# routed sum in slot order against per-expert index_add): ~2e-6 of a leaf's
# largest gradient over seeds 0-4; the float8 control and half the batch
# read 1e-2 and more
GRAD_TOL = 5e-5
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _model(cfg) -> dict:
    return {**{k: getattr(cfg, k) for k in _KEYS}, "dtype": "float32"}


def _weights(model: dict, seed: int) -> dict:
    """The reference's layout drawn from ``seed``: ``{path: f32 tensor}``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for path, shape, _, init in ref.layout(model):
        out[path] = (torch.zeros(shape) if init[0] == "zeros"
                     else torch.randn(shape, generator=gen) * init[1])
    return out


def _tree(flat: dict) -> dict:
    """The program's parameter tree over ``flat``'s tensors."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        for i, key in enumerate(path[:-1]):
            nxt = path[i + 1]
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = t
    return root


def _batch(cfg, seed: int, B: int = 2, S: int = 64) -> dict:
    toks = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)))
    return {"tokens": toks[:, :S].int(), "labels": toks[:, 1:].int()}


def _program(cfg, flat: dict, batch: dict):
    """The port's loss and gradients (``make_train_step``'s value_and_grad,
    remat on) by path."""
    vg = value_and_grad(lambda p, b: model_api.lm_loss(cfg, p, b, remat=True), has_aux=True,
                        unread=transformer.unread_params(cfg))
    (loss, _), grads = vg(_tree(flat), batch)
    by = {}
    for kp, g in pytree.tree_flatten_with_path(grads)[0]:
        by[tuple(k.key if hasattr(k, "key") else k.idx for k in kp)] = g
    return float(loss), by


def _gaps(loss, grads, ref_loss, ref_grads) -> tuple[float, float]:
    """(relative loss gap, the largest leaf gap over the leaf's largest
    reference gradient)."""
    worst = max(float((grads[p] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
                for p, g in ref_grads.items() if float(g.abs().max()) > 0)
    return abs(loss - ref_loss) / abs(ref_loss), worst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_matches_the_reference(seed):
    """Loss and every leaf's gradient of one step (f32, remat on) against
    the reference; the router's bias gets no gradient in either."""
    cfg = get_config(ARCH, smoke=True).reduced(dtype=torch.float32)
    model = _model(cfg)
    flat = _weights(model, seed)
    batch = _batch(cfg, seed)
    loss, grads = _program(cfg, flat, batch)
    ref_loss, ref_grads, kept = ref.loss_and_grads(model, flat, batch)
    assert grads.keys() == ref_grads.keys()
    loss_gap, grad_gap = _gaps(loss, grads, ref_loss, ref_grads)
    assert loss_gap < LOSS_TOL and grad_gap < GRAD_TOL, (loss_gap, grad_gap)
    for i in range(1, cfg.n_layers):
        path = ("layers", i, "mlp", "router_bias")
        assert not grads[path].any() and not ref_grads[path].any()
    assert len(kept) == cfg.n_layers - cfg.first_dense_layers and all(k > 0 for k in kept)


@pytest.mark.parametrize("fault", ["fp8", "half_batch"])
def test_a_fault_fails_the_comparison(fault):
    """The comparison's tolerances catch the float8 control (every product
    one precision below) and half the batch left out."""
    cfg = get_config(ARCH, smoke=True).reduced(dtype=torch.float32)
    model = _model(cfg)
    flat = _weights(model, 0)
    batch = _batch(cfg, 0)
    ref_loss, ref_grads, _ = ref.loss_and_grads(model, flat, batch)
    if fault == "fp8":
        loss, grads, _ = ref.loss_and_grads(model, flat, batch, precision="fp8")
    else:
        loss, grads = _program(cfg, flat, {k: v[:1] for k, v in batch.items()})
    loss_gap, grad_gap = _gaps(loss, grads, ref_loss, ref_grads)
    assert loss_gap > LOSS_TOL or grad_gap > GRAD_TOL


def test_shares_of_a_layer_sum_to_the_uncut_layer():
    """A 64-expert layer cut into the 8 shares of an 8-card node: each share
    routes over all 64 and computes its own experts' part (``first_expert``),
    the shared experts counted in one share; the parts sum to the
    reference's uncut layer (all 64 experts held)."""
    d, f, E, k = 32, 16, 64, 6
    gen = torch.Generator().manual_seed(3)
    full = moe.init_moe_params(d, f, E, torch.float32, generator=gen,
                               device=torch.device("cpu"), n_shared=2, router_bias=True)
    full["router_bias"] = torch.randn(E, generator=gen) * 0.05
    x = torch.randn(2, 48, d, generator=gen)
    kw = dict(top_k=k, scoring="sigmoid", scaling=2.446, n_groups=1)
    total = torch.zeros_like(x)
    for s in range(8):
        share = {n: (t[8 * s:8 * s + 8] if n.startswith("w_") else t)
                 for n, t in full.items() if n != "shared" or s == 0}
        out, aux = moe.moe_ffn(share, x, first_expert=8 * s, **kw)
        assert aux == 0.0
        total = total + out
    model = {"n_experts": E, "n_routed_experts": E, "top_k": k, "capacity_factor": 1.25,
             "routed_scaling": 2.446}
    lp = {f"mlp.{n}": t for n, t in full.items() if n != "shared"}
    lp.update({f"mlp.shared.{n}": t for n, t in full["shared"].items()})
    want, _ = ref.experts(model, lp, x, "fp32")
    torch.testing.assert_close(total, want, atol=2e-6, rtol=2e-5)
    whole, _ = moe.moe_ffn(full, x, **kw)
    torch.testing.assert_close(whole, want, atol=2e-6, rtol=2e-5)


def test_a_shares_unfilled_slots_read_spread_tokens():
    """A share's filled slots hold the routing's tokens; its unfilled slots
    (most of them) read tokens spread over the group, so that no row of the
    dispatch gather's input is read by more than its spread share plus its
    own claims."""
    gen = torch.Generator().manual_seed(4)
    router = torch.randn(32, 64, generator=gen) * 32 ** -0.5
    xg = torch.randn(1, 200, 32, generator=gen)
    cap = moe.capacity_for(200, 6, 1.25, 64)
    routing = moe.route(router, xg, 6, cap, scoring="sigmoid", scaling=2.446)
    slots = moe._share_slots(routing, routing["slot_tok"], 8, 8, cap, 200)
    whole = routing["slot_tok"][:, 8:16]
    assert slots.shape == whole.shape
    held = (routing["expert_idx"] >= 8) & (routing["expert_idx"] < 16) & routing["keep"]
    filled = torch.arange(cap) < torch.stack(
        [(held & (routing["expert_idx"] == e)).sum() for e in range(8, 16)])[:, None]
    assert torch.equal(slots[0, :, :cap][filled], whole[0, :, :cap][filled])
    reads = torch.bincount(slots[0, :, :cap].flatten(), minlength=200)
    assert int(reads.max()) <= -(-8 * cap // 200) + 6 < int(torch.bincount(
        whole[0, :, :cap].flatten()).max())


def test_the_bias_moves_choices_and_not_gates():
    """On some tokens ``topk(scores + bias)`` chooses other experts than
    ``topk(scores)``; the gates are the chosen experts' scores (not
    ``scores + bias``), renormalised, times the scaling."""
    gen = torch.Generator().manual_seed(5)
    router = torch.randn(32, 64, generator=gen) * 32 ** -0.5
    bias = torch.randn(64, generator=gen) * 0.05
    xg = torch.randn(1, 256, 32, generator=gen)
    with_bias = moe.route(router, xg, 6, 64, scoring="sigmoid", bias=bias, scaling=2.446)
    without = moe.route(router, xg, 6, 64, scoring="sigmoid", scaling=2.446)
    chosen = [set(a.tolist()) for a in with_bias["expert_idx"][0]]
    plain = [set(a.tolist()) for a in without["expert_idx"][0]]
    moved = sum(a != b for a, b in zip(chosen, plain))
    assert 0 < moved < 256
    scores = torch.sigmoid(xg.float() @ router)
    g = scores.gather(-1, with_bias["expert_idx"])
    torch.testing.assert_close(with_bias["gate_vals"], g / g.sum(-1, keepdim=True) * 2.446)
    assert with_bias["aux_loss"] == 0.0


def _alike_tokens(seed: int, T: int = 512, d: int = 64, shared: float = 3.0):
    """A router of 64 experts and ``T`` RMS-normed tokens that share a large
    part (9 / 10 of their energy), as random weights' attention gives them
    at long context."""
    gen = torch.Generator().manual_seed(seed)
    router = torch.randn(d, 64, generator=gen) * d ** -0.5
    xg = torch.randn(1, T, d, generator=gen) + shared * torch.randn(d, generator=gen)
    return router, xg * torch.rsqrt((xg * xg).mean(-1, keepdim=True))


def _overflow_share(idx: torch.Tensor, capacity: int, n: int = 64) -> float:
    """The share of claims over their expert's capacity."""
    claims = torch.bincount(idx.reshape(-1), minlength=n)
    return float((claims - capacity).clamp(min=0).sum()) / idx.numel()


@pytest.mark.parametrize("seed", [0, 1])
def test_sigmoid_routing_balances_tokens_that_share_a_part(seed):
    """Tokens with a large shared part would choose the same experts by
    their scores, and most of their claims would overflow; the choice
    subtracts each expert's mean score over the tokens (a trained bias's
    balance) and keeps over 90% of them, and the gates stay the chosen
    experts' scores, renormalised, times the scaling."""
    router, xg = _alike_tokens(seed)
    cap = moe.capacity_for(xg.shape[1], 6, 1.25, 64)
    routing = moe.route(router, xg, 6, cap, scoring="sigmoid", scaling=2.446)
    scores = torch.sigmoid(xg.float() @ router)
    assert _overflow_share(torch.topk(scores, 6, dim=-1).indices, cap) > 0.5
    assert float(routing["keep"].float().mean()) > 0.9
    centred = scores - scores.mean(dim=1, keepdim=True)
    assert torch.equal(routing["expert_idx"], torch.topk(centred, 6, dim=-1).indices)
    g = scores.gather(-1, routing["expert_idx"])
    torch.testing.assert_close(routing["gate_vals"], g / g.sum(-1, keepdim=True) * 2.446)


def test_reference_balances_its_choice_as_the_port():
    """The reference's MoE layer makes the port's balanced choice on tokens
    that share a part: the same output and the same kept claims."""
    router, xg = _alike_tokens(2, T=96, d=32)
    model = {"n_experts": 64, "n_routed_experts": 64, "top_k": 6, "capacity_factor": 1.25,
             "routed_scaling": 2.446}
    gen = torch.Generator().manual_seed(6)
    p = moe.init_moe_params(32, 16, 64, torch.float32, generator=gen,
                            device=torch.device("cpu"), n_shared=2, router_bias=True)
    p["router"] = router
    assert not p["router_bias"].any()
    lp = {f"mlp.{n}": t for n, t in p.items() if n != "shared"}
    lp.update({f"mlp.shared.{n}": t for n, t in p["shared"].items()})
    want, held = ref.experts(model, lp, xg, "fp32")
    got, _ = moe.moe_ffn(p, xg, top_k=6, scoring="sigmoid", scaling=2.446, n_groups=1)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-5)
    cap = moe.capacity_for(96, 6, 1.25, 64)
    assert held == int(moe.route(router, xg, 6, cap, scoring="sigmoid")["keep"].sum())


def test_flash_plain_path_at_latent_attention_widths():
    """B3's plain forward and backward (the CPU path of the training op) with
    q / k 192 wide and v 128 wide against an einsum in f64, and the
    training op's gradients through autograd."""
    B, S, H = 2, 40, 3
    gen = torch.Generator().manual_seed(7)
    q, k = (torch.randn(B, S, H, 192, generator=gen, dtype=torch.float64) for _ in range(2))
    v, do = (torch.randn(B, S, H, 128, generator=gen, dtype=torch.float64) for _ in range(2))

    def einsum(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 192 ** -0.5
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    qe, ke, ve = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = einsum(qe, ke, ve)
    want.backward(do)
    out = flash_attention_plain(q, k, v, True, None, 0, 16, 8)
    assert out.shape == (B, S, H, 128)
    # the plain forward keeps its online-softmax state in f32, as the kernel
    torch.testing.assert_close(out, want.detach(), atol=2e-6, rtol=0)
    from repro_torch.kernels.flash_attention.ops import _plain_forward

    _, lse = _plain_forward(q, k, v, True, None, 0, 16, 8)
    got = flash_attention_bwd_plain(do, q, k, v, out, lse, True, None, 0)
    for a, b in zip(got, (qe.grad, ke.grad, ve.grad)):     # f64, from that f32 state
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    qt, kt, vt = (t.float().clone().requires_grad_(True) for t in (q, k, v))
    flash_attention_train(qt, kt, vt, chunk=16, q_chunk=8).backward(do.float())
    for a, b in zip((qt.grad, kt.grad, vt.grad), (qe.grad, ke.grad, ve.grad)):
        torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=1e-4)


def test_embedding_gradient_sums_in_f32_and_rounds_once():
    """A row named 300 times sums in f32 and rounds once: equal to the f32
    sum rounded to bf16 (PyTorch's own backward of the lookup, which
    rounds after every occurrence, drifts from it); rows no id names are
    zero."""
    gen = torch.Generator().manual_seed(9)
    ids = torch.cat([torch.zeros(300, dtype=torch.long), torch.randint(1, 50, (200,),
                                                                        generator=gen)])
    ids = ids[torch.randperm(500, generator=gen)]
    grad = (torch.randn(500, 64, generator=gen) + 1.0).bfloat16()
    got = transformer.embedding_grad(ids, grad, 64, torch.bfloat16)
    want = torch.zeros(64, 64).index_add_(0, ids, grad.float())
    assert torch.equal(got, want.bfloat16())
    drift = torch.zeros(64, 64, dtype=torch.bfloat16).index_put_((ids,), grad, accumulate=True)
    assert not torch.equal(drift[0], got[0])
    assert not got[50:].any()
    table = torch.randn(64, 64, generator=gen).bfloat16().requires_grad_(True)
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    x = transformer._embed(cfg, {"embed": table}, ids[None])
    torch.testing.assert_close(x, table.detach()[ids][None], atol=0, rtol=0)
    x.backward(grad[None])
    assert torch.equal(table.grad, got)


@pytest.mark.parametrize("remat", [False, True])
def test_spans_and_the_held_counter(remat):
    """A smoke step with the recorder on: ``mla.project`` and ``mla.attend``
    in every layer (again in remat's recompute) and their backward spans,
    ``moe.shared`` (and ``.bwd``) in every MoE layer, and ``moe.held``, the
    kept claims on the held experts, summed on the device, against the
    routing itself."""
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainStepConfig(remat=remat)
    state = init_train_state(cfg, 0, tcfg.adamw, device="cpu")
    step = make_train_step(cfg, tcfg)
    batch = {k: v.numpy() for k, v in _batch(cfg, 0, S=16).items()}
    state, _ = step(state, batch)
    keeps, real_route = [], moe.route

    def route(*a, **k):
        out = real_route(*a, **k)
        keeps.append(out)
        return out

    trace.enable()
    moe.route = route
    try:
        state, _ = step(state, batch)
    finally:
        moe.route = real_route
    trace.disable()
    snap = trace.snapshot()
    fwd = collections.Counter(s["name"] for s in snap["spans"] if not s["attrs"].get("recompute"))
    redo = collections.Counter(s["name"] for s in snap["spans"] if s["attrs"].get("recompute"))
    L, n_moe = cfg.n_layers, cfg.n_layers - cfg.first_dense_layers
    for name in ("mla.project", "mla.attend", "mla.attend.bwd", "mla.project.bwd"):
        assert fwd[name] == L, name
    for name in ("moe.shared", "moe.shared.bwd"):
        assert fwd[name] == n_moe, name
    assert redo["mla.project"] == redo["mla.attend"] == (L if remat else 0)
    assert redo["moe.shared"] == (n_moe if remat else 0)
    (step_id,) = {s["step"] for s in snap["spans"]}
    held = 0
    for r in keeps[:n_moe]:
        idx = r["expert_idx"]
        held += int((r["keep"] & (idx < cfg.n_experts)).sum())
    assert snap["counters"]["moe.held"] == {str(step_id): held}
    assert 0 < held < sum(int(r["keep"].sum()) for r in keeps[:n_moe])


def test_parameter_count_is_the_trees():
    """``n_params`` counts every leaf of ``init_params`` (MLA, the dense
    layer, shared experts, the held share, the router's bias) but the
    final norm's gain, which no config's count has held: 3.365 B at the
    published widths; ``active_params`` the held share's part of each
    token's top-k."""
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        specs = param_specs(cfg, device="cpu")
        assert cfg.n_params() + cfg.d_model == sum(t.numel() for t in pytree.tree_leaves(specs))
    cfg = get_config(ARCH)
    assert cfg.n_params() == 3_364_613_248
    expert = 3 * cfg.d_model * cfg.d_ff
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    assert cfg.n_params() - cfg.active_params() == moe_layers * (8 * expert - 6 * expert // 8)


def test_serving_entry_points_refuse_latent_attention():
    cfg = get_config(ARCH, smoke=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    assert not transformer.serving_supported(cfg) and not transformer.paged_supported(cfg)
    with pytest.raises(ValueError, match="latent attention"):
        transformer.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="latent attention"):
        transformer.prefill(cfg, params, {"tokens": torch.zeros(2, 4, dtype=torch.int32)}, {})
    with pytest.raises(ValueError, match="latent attention"):
        transformer.decode_step(cfg, params, torch.zeros(2, 1, dtype=torch.int32), {})
    with pytest.raises(ValueError, match="latent attention"):
        transformer.init_paged_cache(cfg, 2, 16, n_pages=4, page_size=8, device="cpu")


def test_calibrate_row_halves_each_row(monkeypatch):
    """``bench/calibrate_row.py``'s ``half_row`` fault (a cell of one row has
    no half batch): the first half of each row's tokens and labels; every
    other variant is ``calibrate.py``'s."""
    monkeypatch.syspath_prepend(str(ROOT / "bench"))
    spec = importlib.util.spec_from_file_location("calibrate_row",
                                                  ROOT / "bench" / "calibrate_row.py")
    row = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(row)
    ids = torch.arange(2 * 11, dtype=torch.int32).reshape(1, 22)
    first = [{"tokens": ids[:, :21], "labels": ids[:, 1:]}]
    half = row.variant_batches(first, "half_row", 100)
    assert torch.equal(half[0]["tokens"], ids[:, :10])
    assert torch.equal(half[0]["labels"], ids[:, 1:11])
    altered = row.variant_batches(first, "token_altered", 100)
    assert int(altered[0]["tokens"][0, 0]) == 1 and torch.equal(altered[0]["labels"], ids[:, 1:])
