"""The port's hazard checks (``repro_torch.checks``: effects, hazards,
assertscan, ``verify_all``, the CLI) against the JAX package's.

Hand-built graphs (annotated effects, with and without a schedule) give the
same findings in both packages: rule, severity, node, place and message.
The captured-graph properties are held on the port alone, stated as the
reference's tests state them: the JAX package's capture does not run on
this JAX (ROADMAP C-1), so its paged-pair and scan-body tests fail here.
"""
import dataclasses
import io
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils import _pytree as pytree

import repro.checks as jchecks
import repro.core as jcore
import repro.core.scheduler as jsched
import repro_torch
import repro_torch.checks as tchecks
import repro_torch.core.scheduler as tsched
from repro_torch.core.cost_model import KNL7250
from repro_torch.core.graph import Graph, GraphValidationError
from repro_torch.checks import cli
from repro_torch.configs import get_config
from repro_torch.configs.base import list_archs
from repro_torch.models import transformer
from repro_torch.runtime import Runtime
from repro_torch.serve.step import make_paged_decode_step, make_prefill_chunk_step

SRC = Path(__file__).resolve().parents[1] / "src"
tcore = SimpleNamespace(Graph=Graph, GraphValidationError=GraphValidationError,
                        KNL7250=KNL7250, make_schedule=tsched.make_schedule)
PKGS = {"jax": (jcore, jsched, jchecks), "torch": (tcore, tsched, tchecks)}
ANN = {"effects": {"reads": ["buf"], "writes": ["buf"], "carries": ["buf"]}}
READ = {"effects": {"reads": ["buf"], "writes": [], "carries": []}}


def _findings(rep):
    return [(f.rule_id, f.severity, f.node, f.where, f.message, f.executor)
            for f in rep.findings]


# -- hand-built graphs, built the same way from either package ----------------

def _two_writers(core, _):
    g = core.Graph("haz")
    g.add_op("buf", kind="input")
    g.add_op("w1", deps=("buf",), fn=lambda b: b, meta=dict(ANN))
    g.add_op("w2", deps=("buf",), fn=lambda b: b, meta=dict(ANN))
    return g, None


def _ordered_writers(core, _):
    g = core.Graph("haz-ok")
    g.add_op("buf", kind="input")
    g.add_op("w1", deps=("buf",), fn=lambda b: b, meta=dict(ANN))
    g.add_op("w2", deps=("w1",), fn=lambda b: b, meta=dict(ANN))
    return g, None


def _reader_writer(core, _):
    g = core.Graph("rw")
    g.add_op("buf", kind="input")
    g.add_op("other", kind="input")
    g.add_op("w", deps=("buf",), fn=lambda b: b, meta=dict(ANN))
    g.add_op("r", deps=("buf", "other"), fn=lambda b, o: b, meta=dict(READ))
    g.add_op("opaque", deps=("w",), fn=lambda b: b)      # reads what 'w' carries
    return g, None


def _placed_writers(core, sched):
    g, _ = _two_writers(core, sched)
    s = sched.Schedule(graph_name=g.name, policy="manual", n_executors=1, team_size=1,
                       makespan=2.0, placements={"buf": (0, 0.0, 0.0), "w1": (0, 0.0, 1.0),
                                                 "w2": (0, 1.0, 2.0)})
    return g, s


def _split_writers(core, sched):
    g, _ = _two_writers(core, sched)
    s = sched.Schedule(graph_name=g.name, policy="manual", n_executors=2, team_size=1,
                       makespan=1.0, placements={"buf": (0, 0.0, 0.0), "w1": (0, 0.0, 1.0),
                                                 "w2": (1, 0.0, 1.0)})
    return g, s


def _contradicting_schedule(core, sched):
    g, _ = _ordered_writers(core, sched)
    s = sched.Schedule(graph_name=g.name, policy="manual", n_executors=1, team_size=1,
                       makespan=2.0, placements={"buf": (0, 0.0, 0.0), "w2": (0, 0.0, 1.0),
                                                 "w1": (0, 1.0, 2.0)})
    return g, s


def _many_writers(core, _):
    g = core.Graph("many")
    g.add_op("buf", kind="input")
    for i in range(6):
        g.add_op(f"w{i}", deps=("buf",), fn=lambda b: b, meta=dict(ANN))
    return g, None


BUILDERS = [_two_writers, _ordered_writers, _reader_writer, _placed_writers,
            _split_writers, _contradicting_schedule, _many_writers]


@pytest.mark.parametrize("build", BUILDERS, ids=lambda b: b.__name__.strip("_"))
def test_check_hazards_match_reference(build):
    reps = {}
    for key, (core, sched, checks) in PKGS.items():
        g, s = build(core, sched)
        reps[key] = checks.check_hazards(g, schedule=s)
    assert _findings(reps["torch"]) == _findings(reps["jax"])
    assert reps["torch"].ok == reps["jax"].ok


@pytest.mark.parametrize("build", [_two_writers, _reader_writer, _many_writers],
                         ids=lambda b: b.__name__.strip("_"))
def test_infer_effects_and_verify_all_match_reference(build):
    out = {}
    for key, (core, sched, checks) in PKGS.items():
        g, _ = build(core, sched)
        eff = checks.infer_effects(g)
        s = core.make_schedule(g, core.KNL7250, n_executors=2, team_size=1)
        out[key] = ({n: (e.reads, e.writes, e.source) for n, e in eff.effects.items()},
                    eff.buffers, sorted(eff.written()),
                    _findings(checks.verify_all(g, s, hazards=True)))
    assert out["torch"] == out["jax"]


def test_stale_effects_flagged_like_reference():
    reps = {}
    for key, (core, sched, checks) in PKGS.items():
        g, _ = _two_writers(core, sched)
        eff = checks.infer_effects(g)
        g.add_op("late", deps=("w1",), fn=lambda b: b)
        reps[key] = checks.check_hazards(g, effects=eff)
    assert [f[0] for f in _findings(reps["torch"])] == ["H-STALE"]
    assert _findings(reps["torch"]) == _findings(reps["jax"])


def test_cyclic_graph_flagged_like_reference():
    reps = {}
    for key, (core, sched, checks) in PKGS.items():
        g, _ = _ordered_writers(core, sched)
        eff = checks.infer_effects(g)
        g._nodes["w1"] = dataclasses.replace(g["w1"], deps=("buf", "w2"))
        g._succs["w2"].append("w1")
        g._version += 1
        eff.version = g.version
        reps[key] = checks.check_hazards(g, effects=eff)
    assert [f[0] for f in _findings(reps["torch"])] == ["H-ORDER"]
    assert _findings(reps["torch"]) == _findings(reps["jax"])


@pytest.mark.parametrize("pair", ["ww", "rw", "none"])
def test_cross_graph_hazards_match_reference(pair):
    reps = {}
    for key, (core, sched, checks) in PKGS.items():
        g1, _ = _two_writers(core, sched)
        g2 = _two_writers(core, sched)[0] if pair == "ww" else core.Graph("reader")
        if pair != "ww":
            g2.add_op("buf", kind="input")
            g2.add_op("r", deps=("buf",), fn=lambda b: b,
                      meta=dict(READ if pair == "rw" else
                                {"effects": {"reads": [], "writes": [], "carries": []}}))
        shared = [("buf", "buf")]
        reps[key] = checks.cross_graph_hazards(checks.infer_effects(g1),
                                               checks.infer_effects(g2), shared)
    assert _findings(reps["torch"]) == _findings(reps["jax"])
    rules = {f[0] for f in _findings(reps["torch"])}
    assert rules == ({"H-XWW"} if pair == "ww" else {"H-XRW", "H-XOK"})


def test_shared_buffers_by_identity():
    x, y = torch.zeros(2), torch.ones(3)
    pairs = tchecks.shared_buffers({"a": x, "b": y, "k": 3},
                                   {"c": x, "d": torch.zeros(2), "k2": 3})
    assert pairs == [("a", "c")]


def test_scan_asserts_matches_reference(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text("def f(x):\n    assert x > 0\n    return x\n")
    (tmp_path / "pkg" / "two.py").write_text("assert 1\nx = 'assert in a string'\nassert 2\n")
    (tmp_path / "clean.py").write_text("# assert in a comment\ny = 1\n")
    (tmp_path / "broken.py").write_text("def f(:\n")
    t, j = tchecks.scan_asserts(tmp_path), jchecks.scan_asserts(tmp_path)
    assert _findings(t) == _findings(j)
    assert [f[0] for f in _findings(t)].count("W-ASSERT") == 3
    assert "W-PARSE" in t.by_rule()
    one = tmp_path / "pkg" / "mod.py"
    assert _findings(tchecks.scan_asserts(one)) == _findings(jchecks.scan_asserts(one))


def test_port_tree_has_no_bare_asserts():
    rep = tchecks.scan_asserts()
    assert rep.ok, rep.render()
    assert str(rep.findings[0].where).endswith("repro_torch")


# -- captured graphs: the port alone -------------------------------------------

def _cpu_rt():
    return Runtime(4, device="cpu")


def _buf_of(exe, args, tensor):
    return next(n for n, v in exe.captured.bind(args).items() if v is tensor)


def test_loop_scatter_marks_pool_written():
    # the paged decode's shape: an out-of-place index_put per step of a
    # Python loop (make_fx unrolls it) must mark the pool input written
    def fn(pool, xs):
        for i in range(4):
            pool = pool.index_put((torch.tensor([i]),), xs[i:i + 1] * 2.0)
        return pool, xs.sum()

    pool, xs = torch.zeros(4, 8), torch.ones(4, 8)
    with _cpu_rt() as rt:
        exe = repro_torch.compile(fn, pool, xs, runtime=rt)
        eff = tchecks.infer_effects(exe.graph)
        buf = _buf_of(exe, (pool, xs), pool)
        assert buf in eff.written()
        writers = eff.writers(buf)
        assert writers and all(eff.effects[w].source == "fx" for w in writers)
        assert all("index_put" in exe.graph[w].meta["ops"] for w in writers)
        xbuf = _buf_of(exe, (pool, xs), xs)
        assert xbuf not in eff.written() and eff.readers(xbuf)
        assert exe.verify().ok


def test_unordered_captured_writers_flagged():
    def fn(pool, x):
        a = pool.index_put((torch.tensor([0]),), x)
        b = pool.index_put((torch.tensor([1]),), x * 2.0)
        return a.sum(), b.sum()

    pool, x = torch.zeros(4, 8), torch.ones(1, 8)
    with _cpu_rt() as rt:
        exe = repro_torch.compile(fn, pool, x, runtime=rt, n_executors=2, team_size=1)
        rep = tchecks.check_hazards(exe.graph)        # dep order alone
        assert [f.rule_id for f in rep.errors] == ["H-WW"]
        assert _buf_of(exe, (pool, x), pool) in rep.errors[0].message
        with pytest.raises(tcore.GraphValidationError, match="H-WW"):
            rep.raise_if_errors()
        # under the schedule the pair stays flagged: an error on two
        # executors, a warning where placement happens to serialize it
        ww = [f for f in exe.verify(hazards=True).findings if f.rule_id == "H-WW"]
        assert ww and ww[0].severity in ("error", "warning")
        assert exe.verify(hazards=False).ok


def test_in_place_and_mutating_custom_ops_write():
    @torch.library.custom_op("repro_torch_checks_test::bump", mutates_args=("buf",))
    def bump(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        buf.add_(1.0)
        return x * 2.0

    @bump.register_fake
    def _(buf, x):
        return torch.empty_like(x)

    def fn(a, b, c, x):
        a.copy_(x)
        y = bump(b, x)
        return a.sum() + y.sum() + c.sum()

    args = (torch.zeros(8), torch.zeros(8), torch.zeros(8), torch.ones(8))
    with _cpu_rt() as rt:
        exe = repro_torch.compile(fn, *args, runtime=rt)
        eff = tchecks.infer_effects(exe.graph)
        names = [_buf_of(exe, args, t) for t in args]
        assert names[0] in eff.written() and names[1] in eff.written()
        assert names[2] not in eff.written() and names[3] not in eff.written()


def _tiny_paged(chunk_fn=None):
    cfg = get_config("gemma-2b", smoke=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    B, max_len, page = 2, 32, 8
    n_pt = max_len // page
    pages = transformer.init_paged_cache(cfg, B, max_len, n_pages=B * n_pt, page_size=page,
                                         device="cpu")["pages"]    # ONE pool for both graphs
    i32 = {"dtype": torch.int32}
    cache = {"len": torch.zeros((B,), **i32), "table": torch.full((B, n_pt), -1, **i32),
             "pages": pages}
    rt = _cpu_rt()
    dec = repro_torch.compile(make_paged_decode_step(cfg, page), params, cache,
                              torch.zeros((B, 1), **i32), runtime=rt, name="chk.paged_decode")
    chunk = repro_torch.compile(chunk_fn or make_prefill_chunk_step(cfg, page), params, pages,
                                torch.full((n_pt,), -1, **i32),
                                {"tokens": torch.zeros((1, page), **i32)},
                                torch.tensor(0, **i32), torch.tensor(page, **i32),
                                runtime=rt, name="chk.prefill_chunk")
    bind_d, bind_c = cli.paged_binds(dec, chunk, params, pages, rows=B, n_pt=n_pt,
                                     chunk_len=page, device=torch.device("cpu"))
    return cfg, pages, dec, chunk, bind_d, bind_c, rt


def test_paged_pair_has_zero_write_conflicts():
    cfg, pages, dec, chunk, bind_d, bind_c, rt = _tiny_paged()
    try:
        eff_d, eff_c = tchecks.infer_effects(dec.graph), tchecks.infer_effects(chunk.graph)
        shared = tchecks.shared_buffers(bind_d, bind_c)
        pool_ids = {id(x) for x in pytree.tree_leaves(pages)}
        pool_shared = [(a, b) for a, b in shared if id(bind_d[a]) in pool_ids]
        # every pool leaf is aliased, decode writes each one ...
        assert len(pool_shared) == len(pool_ids) == 2 * cfg.n_layers
        assert {a for a, _ in pool_shared} <= eff_d.written()
        # ... through its scatters only (the attention custom ops read)
        for a, _ in pool_shared:
            assert all("index_put" in dec.graph[w].meta["ops"] for w in eff_d.writers(a))
        # ... the chunk graph is read-only over every shared pool
        assert eff_c.read_only(b for _, b in pool_shared)
        rep = tchecks.cross_graph_hazards(eff_d, eff_c, shared)
        assert not any(f.rule_id == "H-XWW" for f in rep.findings)
        assert rep.ok
        pair = cli.paged_pair_report(dec, chunk, bind_d, bind_c, pytree.tree_leaves(pages), "p")
        assert pair.ok and "C-RO" in pair.by_rule()
        assert dec.verify().ok and chunk.verify().ok
    finally:
        rt.close()


def _plant_index_put(k, row):
    return k.index_put((torch.tensor([0]),), row[None].to(k.dtype))


def _plant_setitem(k, row):
    k[0] = row.to(k.dtype)                        # traces as select + copy_


def _plant_slice_copy(k, row):
    k[:, :1].copy_(row[None, :1].to(k.dtype))     # slice + slice + copy_


@pytest.mark.parametrize("plant", [_plant_index_put, _plant_setitem, _plant_slice_copy],
                         ids=["index_put", "setitem", "slice_copy"])
def test_planted_chunk_writer_is_caught(plant):
    """A chunk graph that writes into a pool breaks the engine's protocol,
    whether out of place or in place through a view of the pool: the pair
    check must report H-XWW and strict must refuse."""
    cfg = get_config("gemma-2b", smoke=True)
    honest = make_prefill_chunk_step(cfg, 8)

    def planted(params, pages, table_row, batch, start, valid_len):
        out = honest(params, pages, table_row, batch, start, valid_len)
        k = pages[0]["k"]
        row = torch.zeros_like(k[0]) + out[0].float().mean()
        return out, plant(k, row)

    _, pages, dec, chunk, bind_d, bind_c, rt = _tiny_paged(planted)
    try:
        rep = cli.paged_pair_report(dec, chunk, bind_d, bind_c, pytree.tree_leaves(pages), "p")
        assert [f for f in rep.errors if f.rule_id == "H-XWW"], rep.render()
        assert "C-RO" not in rep.by_rule()
        with pytest.raises(tcore.GraphValidationError, match="H-XWW"):
            rep.raise_if_errors()
    finally:
        rt.close()


def test_reader_of_an_exported_view_reads_the_pool():
    """A view of a pool handed from one node to another keeps the pool as
    its root: the consumer counts as the pool's reader, and a write through
    the view is a write of the pool."""
    def fn(pool, x):
        v = pool[1:3]
        y = torch.tanh(x) @ torch.tanh(x).T        # a second node between them
        return (v * 2.0).sum() + y.sum()

    def fn_write(pool, x):
        v = pool[1:3]
        y = torch.tanh(x) @ torch.tanh(x).T
        v.copy_(y[:2, :8])
        return y.sum()

    pool, x = torch.zeros(4, 8), torch.ones(8, 8)
    with _cpu_rt() as rt:
        exe = repro_torch.compile(fn, pool, x, runtime=rt)
        eff = tchecks.infer_effects(exe.graph)
        buf = _buf_of(exe, (pool, x), pool)
        readers = eff.readers(buf)
        assert readers and buf not in eff.written()
        assert any("mul" in exe.graph[r].meta["ops"] for r in readers)
        exe_w = repro_torch.compile(fn_write, pool, x, runtime=rt)
        eff_w = tchecks.infer_effects(exe_w.graph)
        assert _buf_of(exe_w, (pool, x), pool) in eff_w.written()


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_compile_strict_and_verify_on_smoke_decode(arch):
    from repro_torch.serve.step import make_decode_step

    cfg = get_config(arch, smoke=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with _cpu_rt() as rt:
        exe = repro_torch.compile(make_decode_step(cfg), params, cache, tok, runtime=rt,
                                  check="strict", n_executors=2, team_size=1)
        exe.host_plan(2)                              # strict-verified build
        rep = exe.verify(hazards=True)
        assert rep.ok, rep.render()
        assert exe.verify(hazards=False, plan=False).ok


@pytest.mark.parametrize("mode", [["--paged", "--page-size", "8", "--prefill-chunk", "8"],
                                  ["--continuous"]])
def test_serve_check_strict_passes_on_smoke(mode, capsys):
    from repro_torch.launch import serve

    base = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--requests", "2",
            "--prompt-len", "8", "--max-new", "2", "--max-batch", "2"]
    assert serve.main(base + mode + ["--check", "strict"]) == 0
    out = capsys.readouterr().out
    assert "check[strict]: 0 error(s), 0 warning(s)" in out
    assert "served 2 requests" in out


@pytest.mark.parametrize("arch", [a.replace("_", "-") for a in list_archs()])
def test_zoo_sweep_on_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--zoo", "--arch", arch, "--device", "cpu", "--no-asserts",
                       "--no-fifo", "-v"])
    out = buf.getvalue()
    assert rc == 0, out
    assert "Z-SKIP" not in out and "TOTAL   : 0 error(s), 0 warning(s)" in out
    if transformer.paged_supported(get_config(arch, smoke=True)):
        assert "C-RO" in out and "H-XOK" in out


def test_checks_module_entry_point():
    res = subprocess.run([sys.executable, "-m", "repro_torch.checks", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fifo    : 0 error(s)" in res.stdout and "asserts : 0 error(s)" in res.stdout
