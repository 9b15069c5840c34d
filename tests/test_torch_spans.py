"""The port's span and counter recorder (``repro_torch.core.trace``) on the
CPU: each thread's stack, parents and steps; the span tree of a smoke
granite train step with remat on and off; the MoE counters against the
routing itself, without a sync; nothing recorded, hooked or launched while
the recorder is off or a graph is captured; ``launch/train.py --spans``;
and the benchmark's reader of spans on a device trace
(``bench/harness/spans.py``, on the hand-made trace in ``bench/tests/``)
and AdamW's least bytes (``bench/roofline/adamw.py``).
"""
import collections
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import trace
from repro_torch.models import moe
from repro_torch.runtime import Runtime
from repro_torch.train.step import (TrainStepConfig, compile_lm_loss, init_train_state,
                                    make_train_step)

BENCH = Path(__file__).resolve().parents[1] / "bench"
ARCH = "granite-moe-1b-a400m"
FORWARD = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
BACKWARD = ("moe.combine.bwd", "moe.experts.bwd", "moe.dispatch.bwd", "moe.route.bwd")


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _bench_module(rel: str):
    """A file of ``bench/`` loaded by path, with ``bench/`` importable as
    its harness sees it."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    name = "_spans_test_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step(remat: bool, seed: int = 0):
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainStepConfig(remat=remat)
    state = init_train_state(cfg, seed, tcfg.adamw, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 17))
    return cfg, make_train_step(cfg, tcfg), state, {"tokens": toks[:, :16], "labels": toks[:, 1:]}


def _path(span, byid):
    names = []
    while span is not None:
        names.append(span["name"])
        span = byid.get(span["parent"])
    return "/".join(reversed(names))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_keep_a_stack_per_thread_with_parents_and_steps():
    trace.enable()
    seen = {}

    def worker():
        with trace.span("w.outer", k=1):
            with trace.span("w.inner"):
                seen["stack"] = [s.name for s in trace._stack()]

    with trace.span("root", root=True):
        with trace.span("a"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with trace.span("b", x=2):
                pass
    with trace.span("after"):
        pass
    snap = trace.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert seen["stack"] == ["w.outer", "w.inner"]        # the worker's own stack
    root = by["root"]
    assert root["parent"] is None and root["step"] == root["id"]
    assert by["a"]["parent"] == root["id"] and by["b"]["parent"] == by["a"]["id"]
    # a thread with no open span hangs under the step's thread's innermost
    assert by["w.outer"]["parent"] == by["a"]["id"]
    assert by["w.inner"]["parent"] == by["w.outer"]["id"]
    assert by["w.outer"]["tid"] != root["tid"] and by["w.inner"]["tid"] == by["w.outer"]["tid"]
    assert {by[n]["step"] for n in ("a", "b", "w.outer", "w.inner")} == {root["id"]}
    assert by["after"]["step"] is None and by["after"]["parent"] is None
    assert by["b"]["attrs"] == {"x": 2} and by["w.outer"]["attrs"] == {"k": 1}
    for s in snap["spans"]:
        assert s["t0_ns"] <= s["t1_ns"]
    assert root["t0_ns"] <= by["a"]["t0_ns"] <= by["b"]["t0_ns"] <= by["b"]["t1_ns"] \
        <= by["a"]["t1_ns"] <= root["t1_ns"]


def test_counters_are_kept_per_step_and_read_at_snapshot():
    trace.enable()
    with trace.span("s", root=True) as s:
        trace.count("c", 3)
        trace.count("c", 4)
        trace.accumulate("d", torch.tensor(5))
        trace.accumulate("d", torch.tensor(6))
    trace.count("c", 1)
    snap = trace.snapshot()
    assert snap["counters"]["c"] == {str(s.id): 7, "None": 1}
    assert snap["counters"]["d"] == {str(s.id): 11}


def test_threads_record_every_span_and_count_under_contention():
    trace.enable()
    n_threads, n = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("root", root=True) as root:
            def work():
                for _ in range(n):
                    with trace.span("outer"):
                        trace.count("c", 1)
                        trace.accumulate("d", torch.ones((), dtype=torch.int64))
                        with trace.span("inner"):
                            pass
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = trace.snapshot()
    spans = snap["spans"]
    assert len(spans) == 2 * n_threads * n + 1
    assert len({s["id"] for s in spans}) == len(spans)
    by = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "inner":
            assert by[s["parent"]]["name"] == "outer" and by[s["parent"]]["tid"] == s["tid"]
    assert snap["counters"]["c"] == {str(root.id): n_threads * n}
    assert snap["counters"]["d"] == {str(root.id): n_threads * n}


def test_spans_and_counters_are_silent_while_off_captured_or_quiet():
    with trace.span("off"):
        trace.count("c", 1)
    trace.enable()
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.ones(2))
        with trace.span("fake mode"):
            with trace.span("inside"):
                trace.accumulate("f", fake.sum())
    with trace.span("of a fake", of=fake):
        with trace.span("silenced too"):
            pass
    with trace.quiet():
        with trace.span("quiet"):
            trace.count("q", 1)
    assert not trace.live(fake)
    assert trace.live(torch.ones(1))
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


# ---------------------------------------------------------------------------
# the train step's span tree and the MoE counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_granite_train_step_span_tree(remat):
    cfg, step, state, batch = _step(remat)
    n_moe = cfg.n_layers
    state, _ = step(state, batch)
    trace.enable()
    state, _ = step(state, batch)
    trace.disable()
    snap = trace.snapshot()
    byid = {s["id"]: s for s in snap["spans"]}
    root = [s for s in snap["spans"] if s["name"] == "train.step"]
    assert len(root) == 1 and root[0]["step"] == root[0]["id"]
    assert {s["step"] for s in snap["spans"]} == {root[0]["id"]}
    paths = collections.Counter(_path(s, byid) for s in snap["spans"])
    for phase in ("train.batch", "train.forward", "train.backward", "train.optimizer",
                  "train.optimizer/optim.adamw", "train.optimizer/optim.adamw/optim.clip",
                  "train.optimizer/optim.adamw/optim.update"):
        assert paths["train.step/" + phase] == 1, phase
    fwd = collections.Counter(s["name"] for s in snap["spans"]
                              if not s["attrs"].get("recompute"))
    redo = collections.Counter(s["name"] for s in snap["spans"] if s["attrs"].get("recompute"))
    for name in FORWARD:
        assert paths[f"train.step/train.forward/{name}"] == n_moe
        assert fwd[name] == n_moe
        assert redo[name] == (n_moe if remat else 0)
    for name in BACKWARD:
        assert fwd[name] == n_moe
        assert paths[f"train.step/train.backward/{name}"] == n_moe
    assert redo.keys() <= set(FORWARD)
    recomputes = [s for s in snap["spans"] if s["name"] == "model.recompute"]
    assert len(recomputes) == (cfg.n_layers if remat else 0)
    for s in snap["spans"]:
        if s["attrs"].get("recompute"):
            assert byid[s["parent"]]["name"] == "model.recompute"
    # each layer's backward spans follow one another: combine, experts, dispatch, route
    bwd = sorted((s for s in snap["spans"] if s["name"] in BACKWARD), key=lambda s: s["t0_ns"])
    assert [s["name"] for s in bwd] == list(BACKWARD) * n_moe
    for a, b in zip(bwd, bwd[1:]):
        assert a["t1_ns"] <= b["t0_ns"]


def test_microbatches_get_a_forward_and_backward_each_and_the_accumulation():
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainStepConfig(remat=False, microbatches=2)
    state = init_train_state(cfg, 0, tcfg.adamw, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17))
    step = make_train_step(cfg, tcfg)
    trace.enable()
    step(state, {"tokens": toks[:, :16], "labels": toks[:, 1:]})
    spans = trace.snapshot()["spans"]
    byid = {s["id"]: s for s in spans}
    top = [(s["name"], s["attrs"].get("micro")) for s in sorted(spans, key=lambda s: s["t0_ns"])
           if byid.get(s["parent"], {}).get("name") == "train.step"]
    assert top == [("train.batch", None), ("train.forward", 0), ("train.backward", 0),
                   ("train.accumulate", 0), ("train.forward", 1), ("train.backward", 1),
                   ("train.accumulate", 1), ("train.accumulate", None),
                   ("train.optimizer", None)]
    assert sum(s["name"] == "moe.route" for s in spans) == 2 * cfg.n_layers


class _Ops(TorchDispatchMode):
    """Counts the ops run, by the innermost span open on this thread."""

    def __init__(self):
        super().__init__()
        self.by_span = collections.defaultdict(collections.Counter)
        self.all = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        stack = trace._stack()
        self.by_span[stack[-1].name if stack else None][func.overloadpacket.__name__] += 1
        self.all.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [False, True])
def test_each_backward_span_holds_its_own_part(remat):
    """The hooks split the backward where the parts meet: the slot gather's
    accumulate in dispatch's, the expert products' backward in experts',
    the softmax's in route's."""
    _, step, state, batch = _step(remat)
    trace.enable()
    with _Ops() as ops:
        step(state, batch)
    assert ops.by_span["moe.experts.bwd"]["moe_gmm_bwd"] == 6   # 3 products x 2 layers
    assert ops.by_span["moe.dispatch.bwd"]["index_put"] == 2
    assert ops.by_span["moe.route.bwd"]["_softmax_backward_data"] == 2
    assert ops.by_span["moe.combine.bwd"]["index_put"] == 2
    for name in ("moe.dispatch.bwd", "moe.combine.bwd", "moe.experts.bwd"):
        assert ops.by_span[name]["_softmax_backward_data"] == 0
    runs = 2 if remat else 1                     # remat's recompute runs them again
    # the slot assignment is one op (on the CPU its plain count runs inside it)
    assert ops.by_span["moe.route"]["moe_route_slots"] == 2 * runs
    assert ops.by_span["moe.route"]["cumsum"] == 0
    assert ops.by_span["moe.experts"]["moe_gmm"] == 6 * runs


@pytest.mark.parametrize("remat", [False, True])
def test_kept_counter_equals_the_routing_without_a_sync(remat, monkeypatch):
    cfg, step, state, batch = _step(remat, seed=3)
    state, _ = step(state, batch)                          # warm, recorder off
    keeps, real_route = [], moe.route

    def route(*a, **k):
        out = real_route(*a, **k)
        keeps.append(out["keep"].detach().clone())
        return out

    def no_item(self):
        raise AssertionError("the counters synchronised")

    trace.enable()
    monkeypatch.setattr(moe, "route", route)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    state, _ = step(state, batch)
    monkeypatch.undo()
    trace.disable()
    snap = trace.snapshot()
    (step_id,) = {s["step"] for s in snap["spans"]}
    # the first forward's routing, then (with remat) the recompute's, the same
    assert len(keeps) == cfg.n_layers * (2 if remat else 1)
    first = keeps[:cfg.n_layers]
    assert all(torch.equal(a, b) for a, b in zip(first, keeps[cfg.n_layers:]))
    assert snap["counters"]["moe.kept"] == {str(step_id): sum(int(k.sum()) for k in first)}
    G, Tg, k = first[0].shape
    E = cfg.n_experts
    capacity = moe.capacity_for(Tg, cfg.top_k, cfg.capacity_factor, E)
    assert snap["counters"]["moe.claims"] == {str(step_id): cfg.n_layers * G * k * Tg}
    assert snap["counters"]["moe.slots"] == {str(step_id): cfg.n_layers * G * E * capacity}
    # every layer's first forward took the plain count (a CPU tensor)
    assert snap["counters"]["moe.route_plain"] == {str(step_id): cfg.n_layers}
    assert snap["counters"]["moe.route_kernel"] == {str(step_id): 0}


def test_recorder_off_registers_no_hook_and_adds_no_op(monkeypatch):
    """Off, ``moe_ffn`` runs exactly the ops of its parts and the step
    registers no hook; on, the parts are the same ops plus the views and
    the counter's."""
    cfg = get_config(ARCH, smoke=True)
    params = moe.init_moe_params(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.float32,
                                 generator=torch.Generator().manual_seed(0),
                                 device=torch.device("cpu"))
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, act=cfg.act)

    def parts():
        xg = x.reshape(1, 16, cfg.d_model)
        cap = moe.capacity_for(16, cfg.top_k, cfg.capacity_factor, cfg.n_experts)
        r = moe.route(params["router"], xg, cfg.top_k, cap)
        y = moe.experts(params, moe.dispatch(xg, r["slot_tok"], cap), cfg.act)
        return moe.combine(y, r).reshape(2, 8, -1).to(x.dtype), r["aux_loss"]

    hooks = []
    real = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(fn) or real(self, fn))
    with _Ops() as off:
        out, aux = moe.moe_ffn(params, x, **kw)
    (out.sum() + aux).backward()
    with _Ops() as plain:
        parts()
    assert off.all == plain.all and not hooks

    _, step, state, batch = _step(True)
    step(state, batch)
    assert not hooks
    trace.enable()
    with _Ops() as on:
        moe.moe_ffn(params, x, **kw)
    extra = collections.Counter(on.all) - collections.Counter(plain.all)
    assert extra == collections.Counter({"view": 2, "sum": 1}), extra
    assert len(hooks) == 5


def test_capture_has_the_same_nodes_with_the_recorder_on():
    cfg = get_config(ARCH, smoke=True).reduced(dtype=torch.float32)
    shape = ShapeSpec("t", 16, 2, "train")
    counts = []
    with Runtime(2, device="cpu") as rt:
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            exe = compile_lm_loss(cfg, shape, backend="host", grad=True, remat=True,
                                  runtime=rt, device="cpu")
            counts.append((len(exe.graph), collections.Counter(n.kind for n in exe.graph.nodes)))
    assert counts[0] == counts[1]
    assert trace.snapshot() == {"clock": "time_ns", "spans": [], "counters": {}}


def test_train_cli_writes_spans_on_the_profiler_time_base(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = tmp_path / "spans.json"
    assert main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq", "8", "--no-graphi", "--log-every", "1", "--spans", str(out)]) == 0
    assert "spans:" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    base = doc["baseTimeNanoseconds"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    roots = [e for e in spans if e["name"] == "train.step"]
    assert len(roots) == 2 and all(e["args"]["step"] == e["args"]["id"] for e in roots)
    assert {e["name"] for e in spans} >= {"train.forward", "optim.adamw", "moe.route",
                                         "moe.dispatch.bwd"}
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert counters == {"moe.kept", "moe.slots", "moe.claims", "moe.route_kernel",
                        "moe.route_plain", "optim.fused_leaves", "optim.plain_leaves"}
    # ts + baseTimeNanoseconds / 1000 is time.time_ns() in µs, as torch.profiler writes it
    import time

    now_us = time.time_ns() / 1e3
    for e in spans:
        assert 0 <= now_us - (e["ts"] + base / 1e3) < 600e6 and e["dur"] >= 0


# ---------------------------------------------------------------------------
# the benchmark's reader
# ---------------------------------------------------------------------------

def test_bench_reader_attributes_kernels_and_gaps_on_a_hand_made_trace():
    spans = _bench_module("harness/spans.py")
    doc = json.loads((BENCH / "tests" / "spans_trace.json").read_text())
    s = spans.read(doc["chrome"], doc["program"])
    # the offset: the two markers bound it to 6..8 µs
    assert s["offset_us"] == pytest.approx(7.0) and s["within_us"] == pytest.approx(1.0)
    assert s["consistent"] and s["markers"] == 2 and s["steps"] == 2
    k = s["by_kernel"]
    # joined by correlation, the innermost span on the launching thread
    assert k["indexing_backward_kernel"] == {"moe.dispatch.bwd": pytest.approx(0.03)}
    # a launch on the main thread while autograd's thread is in a MoE span
    assert k["Memcpy DtoD"] == {"train.backward": pytest.approx(0.005)}
    # a thread with no open span: the innermost open anywhere
    assert k["flash_bwd_dq_mma"] == {"train.backward": pytest.approx(0.01)}
    # launched 2 µs before moe.route opens on the program's clock (inside it
    # on the trace's unless the offset is taken off)
    assert k["vectorized_elementwise_kernel"]["train.forward"] == pytest.approx(0.005)
    assert k["tensor_kernel_scan_outer_dim"] == {"moe.route": pytest.approx(0.01),
                                                 "moe.route.recompute": pytest.approx(0.02)}
    assert "spin_kernel" not in k                    # the markers lie outside the steps
    assert s["attributed_share"] == pytest.approx(1.0)
    lab = s["labels"]
    assert lab["train.forward"]["device_ms"] == pytest.approx((0.02 + 0.01 + 0.04) / 2)
    assert lab["train.forward"]["self_device_ms"] == pytest.approx(0.01 / 2)
    assert lab["train.step"]["launches"] == pytest.approx(6 / 2)   # kernels, not the copy
    # gaps by the span open at their middle, on any thread
    idle = s["idle_by_span"]
    assert idle["moe.dispatch.bwd"] == pytest.approx(0.08 / 2)   # 2480..2560, autograd's thread
    assert idle["train.forward"] == pytest.approx((0.063 + 0.35) / 2)   # not moe.route's at 2110
    assert idle["moe.route"] == pytest.approx(0.01 / 2)
    assert s["busy_ms"] == pytest.approx(0.2 / 2)
    assert spans.routing_ms(s) == pytest.approx((0.02 + 0.04 + 0.06) / 2)
    assert spans.optimizer_ms(s) is None
    assert spans.moe_slot_fill(s) == pytest.approx(100 * 32 / 40)
    assert spans.moe_kept_share(s) == pytest.approx(100 * 32 / 34)
    assert spans.share_in(s, ("indexing_backward", "tensor_kernel_scan"),
                          ("moe.route", "moe.route.recompute", "moe.dispatch.bwd")) == 1.0


def test_bench_reader_refuses_a_trace_without_launch_events():
    """Kernels with no launch to join them to cannot be put in a span: the
    reader raises rather than attribute them some other way."""
    spans = _bench_module("harness/spans.py")
    doc = json.loads((BENCH / "tests" / "spans_trace.json").read_text())
    chrome = {**doc["chrome"], "traceEvents": [
        e for e in doc["chrome"]["traceEvents"]
        if e.get("cat") not in spans.LAUNCH_CATS]}
    with pytest.raises(ValueError, match="no launch event"):
        spans.read(chrome, doc["program"])


def test_bench_reader_merges_device_intervals_and_clips_their_holes():
    spans = _bench_module("harness/spans.py")
    merged = spans.busy_intervals([(0.0, 5.0), (3.0, 4.0), (10.0, 1.0), (11.0, 2.0)])
    assert merged == [[0.0, 7.0], [10.0, 13.0]]
    assert spans.holes(merged, -2.0, 20.0) == [(-2.0, 0.0), (7.0, 10.0), (13.0, 20.0)]
    assert spans.holes(merged, 1.0, 12.0) == [(7.0, 10.0)]
    assert spans.holes([], 1.0, 3.0) == [(1.0, 3.0)]


def test_bench_reader_pairs_clock_markers_burst_by_burst():
    """Markers come in a burst before the steps and one after; where the
    trace lost one burst's kernels, the other alone places the clock."""
    spans = _bench_module("harness/spans.py")
    base = 10**12

    def mark(t0, t1):
        return {"name": "bench.clock", "t0_ns": base + t0 * 1000, "t1_ns": base + t1 * 1000}

    before = [mark(1000, 1010), mark(1020, 1031), mark(1045, 1052)]
    after = [mark(900_000, 900_010), mark(900_030, 900_036), mark(900_050, 900_061)]
    # the trace's clock is 5 µs ahead; only the later burst's kernels were kept
    kept = [(900_006.0, 900_013.0), (900_036.0, 900_040.0), (900_056.0, 900_064.0)]
    c = spans.clock_offset(before + after, kept, base)
    assert c["consistent"] and c["markers"] == 3 and c["marker_spans"] == 6
    assert 4.0 <= c["offset_us"] <= 6.0 and c["within_us"] <= 2.0
    both = [(1006.0, 1013.0), (1026.0, 1030.0), (1051.0, 1055.0)] + kept
    c2 = spans.clock_offset(before + after, both, base)
    assert c2["consistent"] and c2["markers"] == 6 and 4.0 <= c2["offset_us"] <= 6.0


def test_bench_reader_marks_a_clock_the_markers_do_not_agree_on():
    spans = _bench_module("harness/spans.py")
    base = 10**12
    marks = [{"name": "bench.clock", "t0_ns": base + 1000_000, "t1_ns": base + 1010_000},
             {"name": "bench.clock", "t0_ns": base + 2000_000, "t1_ns": base + 2010_000}]
    c = spans.clock_offset(marks, [(1002.0, 1004.0), (2080.0, 2082.0)], base)
    assert not c["consistent"] and c["within_us"] > 20


def test_adamw_least_bytes_by_hand():
    adamw = _bench_module("roofline/adamw.py")
    assert adamw.element_bytes("bfloat16") == 22 and adamw.element_bytes("float32") == 28
    leaves = [(("a",), (3, 4), "bfloat16", ("zeros",)), (("b",), (5,), "float32", ("zeros",))]
    assert adamw.least_bytes(leaves) == 12 * 22 + 5 * 28
