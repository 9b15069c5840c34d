"""Capture on ``make_fx``: replay is bit-exact, nodes are priced by the
DESIGN.md §3 conventions, fusion leaves no single-consumer movement or
elementwise node behind, and the paged-attention custom op is one node.
All comparisons are exact (the replay runs the same aten ops)."""
import numpy as np
import pytest
import torch

from repro_torch.api import compile as rt_compile
from repro_torch.core.capture import _FUSABLE_KINDS, _kind_of, capture
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.runtime import Runtime
from repro_torch.serve.step import make_paged_decode_step, make_prefill_chunk_step

PS = 8


@pytest.fixture(scope="module")
def model():
    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    params = tt.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    cache = tt.init_paged_cache(cfg, 3, 64, n_pages=24, page_size=PS, device="cpu")
    for pg in cache["pages"]:
        for kk in ("k", "v"):
            pg[kk] = torch.as_tensor(rng.standard_normal(tuple(pg[kk].shape)), dtype=torch.float32)
    table = np.full((3, 8), -1, np.int32)
    table[0, :2] = [5, 7]
    table[1, :1] = [9]
    dcache = {"len": torch.tensor([10, 4, 0], dtype=torch.int32),
              "table": torch.as_tensor(table), "pages": cache["pages"]}
    tokens = torch.tensor([[3], [7], [0]], dtype=torch.int32)
    return cfg, params, dcache, tokens


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)


def test_decode_capture_replays_bit_exactly(model):
    cfg, params, cache, tokens = model
    step = make_paged_decode_step(cfg, PS)
    cg = capture(step, params, cache, tokens)
    _assert_same(cg.run(params, cache, tokens), step(params, cache, tokens))


def test_chunk_capture_replays_bit_exactly(model):
    cfg, params, cache, _ = model
    step = make_prefill_chunk_step(cfg, PS)
    args = (params, cache["pages"], cache["table"][0], {"tokens": torch.arange(16)[None].int()},
            torch.tensor(16, dtype=torch.int32), torch.tensor(11, dtype=torch.int32))
    cg = capture(step, *args)
    _assert_same(cg.run(*args), step(*args))


def test_matmul_node_reports_2mnk_flops():
    M, K, N = 6, 5, 7
    x, w = torch.randn(M, K), torch.randn(K, N)
    cg = capture(lambda a, b: torch.matmul(a, b), x, w)
    (mm,) = [n for n in cg.graph.nodes if n.kind == "gemm"]
    assert mm.flops == 2 * M * N * K
    assert mm.meta["rows"] == M
    assert mm.bytes_in == (M * K + K * N) * 4 and mm.bytes_out == M * N * 4


def test_index_put_is_priced_by_its_update():
    pool = torch.zeros(1000, 16)
    rows = torch.tensor([3, 9])
    upd = torch.ones(2, 16)
    cg = capture(lambda p, r, u: p.index_put((r,), u), pool, rows, upd)
    (node,) = [n for n in cg.graph.nodes if n.kind != "input"]
    assert node.flops == upd.numel()
    torch.testing.assert_close(cg.run(pool, rows, upd)[9], upd[1])


def test_no_fusable_single_consumer_node_survives(model):
    cfg, params, cache, tokens = model
    cg = capture(make_paged_decode_step(cfg, PS), params, cache, tokens)
    g = cg.graph
    outputs = {spec[1] for spec in cg.out_spec if spec[0] == "node"}
    n_fusable = 0
    for n in g.nodes:
        if n.kind == "input" or _kind_of(n.meta["_fx_nodes"][-1]) not in _FUSABLE_KINDS:
            continue
        n_fusable += 1
        # a movement/elementwise group survives only when it feeds several
        # groups or is (part of) the function's output
        assert len(g.successors(n.name)) != 1 or n.name in outputs, n.name
    assert n_fusable > 0
    unfused = capture(make_paged_decode_step(cfg, PS), params, cache, tokens, fuse=False).graph
    assert len(g) < len(unfused)


def test_paged_attention_custom_op_is_one_node(model):
    cfg, params, cache, tokens = model
    g = capture(make_paged_decode_step(cfg, PS), params, cache, tokens).graph
    att = [n for n in g.nodes if n.kind == "attention"]
    assert len(att) == cfg.n_layers
    for n in att:
        assert n.meta["ops"].count("paged_decode_attention") == 1
        assert n.meta["ops"][-1] == "paged_decode_attention"


def test_paged_attention_is_priced_by_the_pages_its_table_reaches():
    B, Hq, Hkv, hd, P, ps, n_pt = 2, 4, 1, 16, 200, 8, 3
    q = torch.randn(B, Hq, hd)
    pool = torch.randn(P, ps, Hkv, hd)
    table = torch.tensor([[4, 9, -1], [7, -1, -1]], dtype=torch.int32)
    q_pos = torch.tensor([12, 3], dtype=torch.int32)
    cg = capture(lambda *a: paged_decode_attention(*a), q, pool, pool.clone(), table, q_pos)
    (node,) = [n for n in cg.graph.nodes if n.kind == "attention"]
    reach = B * n_pt * ps                      # entries the tables can map
    assert node.flops == 4 * reach * Hq * hd
    assert node.bytes_in == (q.numel() * 4 + table.numel() * 4 + q_pos.numel() * 4
                             + 2 * reach * Hkv * hd * 4)
    assert node.bytes_in < 2 * pool.numel() * 4


def test_fx_nodes_and_host_runtimes_match_execute(model):
    cfg, params, cache, tokens = model
    step = make_paged_decode_step(cfg, PS)
    ref = step(params, cache, tokens)
    with Runtime(n_workers=3, device="cpu") as rt:
        exe = rt_compile(step, params, cache, tokens, runtime=rt, jit_nodes=True,
                         n_executors=3, team_size=1)
        assert all(isinstance(n.fn, torch.fx.GraphModule)
                   for n in exe.graph.nodes if n.fn is not None)
        inputs = exe.captured.bind((params, cache, tokens))
        for mode in ("static", "dynamic"):
            res = exe.execute_host(inputs, host_mode=mode)
            _assert_same(exe.captured.unflatten(res.outputs), ref)
        _assert_same(exe(params, cache, tokens), ref)
