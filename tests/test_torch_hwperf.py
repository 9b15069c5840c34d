"""The port's hwperf layer (``repro_torch.hwperf``: topology, pinning, the
co-location harness, the contention model and the ``cpf-contention``
policy) against the JAX package's, and its wiring into the port's Runtime,
pool and CLIs on the CPU.

Topologies, pinning plans, contention models, contention-adjusted
simulated makespans and the ``cpf-contention`` schedules of the paper's
networks compare equal in both packages.  Pinning real pool threads, the
harness, the runtime modes and the CLIs are the port's own.
"""
import dataclasses
import os
import warnings

import pytest
import torch

import repro.hwperf as jhw
import repro_torch.hwperf as thw
from repro.core import KNL7250 as J_KNL
from repro.core import SimConfig as JSimConfig
from repro.core import simulate as jsimulate
from repro.core.policies import list_policies as j_list_policies
from repro.core.policies import unregister_policy as j_unregister
from repro.models import paper_nets as j_nets
from repro_torch.core.cost_model import KNL7250 as T_KNL
from repro_torch.core.engine import ExecutorPool
from repro_torch.core.graph import Graph
from repro_torch.core.policies import get_policy, list_policies, unregister_policy
from repro_torch.core.scheduler import make_schedule
from repro_torch.core.simulate import SimConfig, simulate
from repro_torch.hwperf import pinning as hwpin
from repro_torch.models import paper_nets as t_nets
from repro_torch.runtime import CalibrationStore, Runtime

PKGS = {"jax": jhw, "torch": thw}


@pytest.fixture(autouse=True)
def _fresh_warning_state():
    """Each test sees the one-shot pinning warning as if freshly imported."""
    hwpin._reset_warning_for_tests()
    yield
    hwpin._reset_warning_for_tests()


@pytest.fixture
def no_affinity(monkeypatch):
    """Behave as a platform without sched_setaffinity."""
    monkeypatch.setenv(thw.NO_AFFINITY_ENV, "1")


@pytest.fixture
def clean_policy():
    yield
    for names, drop in ((list_policies(), unregister_policy),
                        (j_list_policies(), j_unregister)):
        if "cpf-contention" in names:
            drop("cpf-contention")


def _topo(t):
    return ([dataclasses.astuple(c) for c in t.cpus], t.source, t.describe(),
            t.physical_cores(), t.sockets, t.nodes, t.smt)


# -- topology and pinning plans: parity ---------------------------------------

SHAPES = [(1, {}), (2, {}), (8, {}), (8, {"smt": 2}), (8, {"sockets": 2}),
          (16, {"sockets": 2, "smt": 2}), (6, {"smt": 2, "sockets": 3})]


@pytest.mark.parametrize("n,kw", SHAPES)
def test_synthetic_topology_and_core_sets_match_reference(n, kw):
    t, j = thw.synthetic_topology(n, **kw), jhw.synthetic_topology(n, **kw)
    assert _topo(t) == _topo(j)
    for n_sets in (1, 2, 3, 4, 5, 9):
        for per in (None, 1, 2, 100):
            assert (thw.disjoint_core_sets(t, n_sets, cpus_per_set=per)
                    == jhw.disjoint_core_sets(j, n_sets, cpus_per_set=per))
    for n_exec in (1, 2, 4, 8, 12):
        tp, jp = thw.plan_pinning(n_exec, t), jhw.plan_pinning(n_exec, j)
        assert (tp.assignments, tp.disjoint, tp.describe()) == \
            (jp.assignments, jp.disjoint, jp.describe())
        assert [tp.cpus_for(e) for e in range(2 * n_exec)] == \
            [jp.cpus_for(e) for e in range(2 * n_exec)]


def test_topology_rejections_match_reference():
    for mod in PKGS.values():
        with pytest.raises(ValueError):
            mod.synthetic_topology(0)
        with pytest.raises(ValueError):
            mod.synthetic_topology(2, smt=0)
        with pytest.raises(ValueError):
            mod.disjoint_core_sets(mod.synthetic_topology(2), 0)
        with pytest.raises(ValueError, match="not in this topology"):
            mod.synthetic_topology(2).smt_siblings(7)


def _fake_sysfs(root, layout):
    """layout: {cpu: (core, socket, node|None)}"""
    for cpu, (core, socket, node) in layout.items():
        d = os.path.join(root, "devices", "system", "cpu", f"cpu{cpu}", "topology")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "core_id"), "w") as f:
            f.write(f"{core}\n")
        with open(os.path.join(d, "physical_package_id"), "w") as f:
            f.write(f"{socket}\n")
        if node is not None:
            os.makedirs(os.path.join(d, os.pardir, f"node{node}"), exist_ok=True)


@pytest.mark.parametrize("layout,usable", [
    ({0: (0, 0, 0), 1: (0, 0, 0)}, [0, 1]),                           # one SMT core
    ({0: (0, 0, 0), 1: (1, 0, 0), 2: (0, 1, 1), 3: (1, 1, 1)}, [0, 1, 2, 3]),
    ({0: (0, 0, None), 1: (1, 0, None), 2: (2, 0, None)}, [0, 2]),     # no node dirs
    ({0: (0, 0, None)}, [0, 1]),                                       # partial: flat
])
def test_detect_topology_on_fake_sysfs_matches_reference(tmp_path, monkeypatch, layout, usable):
    _fake_sysfs(str(tmp_path), layout)
    monkeypatch.setattr("repro.hwperf.topology._usable_cpus", lambda: list(usable))
    monkeypatch.setattr("repro_torch.hwperf.topology._usable_cpus", lambda: list(usable))
    t = thw.detect_topology(sysfs=str(tmp_path))
    assert _topo(t) == _topo(jhw.detect_topology(sysfs=str(tmp_path)))
    assert t.n_cpus == len(usable)


def test_detect_real_machine_matches_reference():
    t = thw.detect_topology()
    assert _topo(t) == _topo(jhw.detect_topology())
    if hasattr(os, "sched_getaffinity"):
        assert t.n_cpus == len(os.sched_getaffinity(0))


# -- contention model: parity -------------------------------------------------

SOLO = {"gemm": 2.0, "elementwise": 0.5, "memory": 1.0}
PAIR = {("gemm", "gemm"): 3.0, ("gemm", "elementwise"): 2.1, ("elementwise", "gemm"): 0.9,
        ("gemm", "memory"): 2.2, ("memory", "gemm"): 1.9, ("elementwise", "elementwise"): 0.51,
        ("elementwise", "memory"): 0.8, ("memory", "elementwise"): 1.1,
        ("memory", "memory"): 1.6}


def _matrix(mod, **kw):
    return mod.InterferenceMatrix(solo=dict(SOLO), pair=dict(PAIR), pinned=True, disjoint=True,
                                  **kw)


@pytest.mark.parametrize("threshold", [1.05, 1.25, 1.5, 3.0])
def test_contention_model_matches_reference(threshold):
    tm = thw.ContentionModel.from_matrix(_matrix(thw, device="NVIDIA H100"),
                                         hot_threshold=threshold)
    jm = jhw.ContentionModel.from_matrix(_matrix(jhw), hot_threshold=threshold)
    assert tm.to_dict() == jm.to_dict()
    assert tm.hot_classes() == jm.hot_classes()
    classes = sorted(SOLO) + ["unknown"]
    for a in classes:
        for co in ([], ["gemm"], ["memory", "elementwise"], classes):
            assert tm.multiplier(a, co) == jm.multiplier(a, co)
        for b in classes:
            assert tm.pair_cost(a, b) == jm.pair_cost(a, b)
            assert _matrix(thw).slowdown(a, b) == _matrix(jhw).slowdown(a, b)
    back_t = thw.ContentionModel.from_dict(jm.to_dict())   # the store format crosses
    back_j = jhw.ContentionModel.from_dict(tm.to_dict())
    assert back_t.to_dict() == back_j.to_dict() == jm.to_dict()


def test_classify_matches_reference():
    g = Graph("k")
    for kind in ("gemm", "conv", "attention", "elementwise", "scan", "generic", "input",
                 "reduce", "lstm_cell", "ssm_scan", "rglru_scan", "ssm_scan_bwd", "exotic"):
        node = g.add_op(kind, kind=kind)
        assert thw.classify(node) == jhw.classify(node)
    assert thw.classify(object()) == jhw.classify(object()) == "elementwise"


def _parallel_ops(G, kinds):
    g = G("par")
    for i, k in enumerate(kinds):
        g.add_op(f"o{i}", kind=k, flops=1e9 * (i + 1), bytes_in=1e6, bytes_out=1e6)
    return g


@pytest.mark.parametrize("n_exec", [1, 2, 4])
def test_contention_adjusted_makespans_match_reference(n_exec):
    from repro.core import Graph as JGraph

    kinds = ["gemm", "elementwise", "gemm", "input", "attention", "elementwise"]
    tm = thw.ContentionModel.from_matrix(_matrix(thw))
    jm = jhw.ContentionModel.from_matrix(_matrix(jhw))
    t = simulate(_parallel_ops(Graph, kinds), T_KNL,
                 SimConfig(n_executors=n_exec, team_size=2, contention=tm))
    j = jsimulate(_parallel_ops(JGraph, kinds), J_KNL,
                  JSimConfig(n_executors=n_exec, team_size=2, contention=jm))
    assert t.makespan == j.makespan
    assert [dataclasses.astuple(e) for e in t.trace] == [dataclasses.astuple(e) for e in j.trace]
    plain = simulate(_parallel_ops(Graph, kinds), T_KNL, SimConfig(n_executors=n_exec,
                                                                   team_size=2))
    assert t.makespan >= plain.makespan


@pytest.mark.parametrize("n_exec", [2, 4, 8])
@pytest.mark.parametrize("net", t_nets.PAPER_NETS)
def test_cpf_contention_schedule_on_paper_nets_matches_reference(net, n_exec, clean_policy):
    tm = thw.ContentionModel.from_matrix(_matrix(thw), hot_threshold=1.2)
    jm = jhw.ContentionModel.from_matrix(_matrix(jhw), hot_threshold=1.2)
    tp, jp = thw.install_contention_policy(tm), jhw.install_contention_policy(jm)
    assert get_policy("cpf-contention") is tp
    tg, jg = t_nets.paper_graph(net, "small"), j_nets.paper_graph(net, "small")
    t = simulate(tg, T_KNL, SimConfig(n_executors=n_exec, team_size=2, policy=tp,
                                      contention=tm))
    j = jsimulate(jg, J_KNL, JSimConfig(n_executors=n_exec, team_size=2, policy=jp,
                                        contention=jm))
    assert t.makespan == j.makespan
    assert [(e.op, e.executor, e.start) for e in t.trace] == \
        [(e.op, e.executor, e.start) for e in j.trace]
    # the registry name resolves to the same schedule
    s = make_schedule(tg, T_KNL, n_executors=n_exec, team_size=2, policy="cpf-contention")
    from repro.core import make_schedule as j_make_schedule

    js = j_make_schedule(jg, J_KNL, n_executors=n_exec, team_size=2, policy="cpf-contention")
    assert s.start_order() == js.start_order() and s.makespan == js.makespan
    assert s.placements == js.placements


def test_assign_executor_steering_matches_reference():
    """The placement hook itself, call by call: a hot class steers away from
    the executor whose last op it contends with, ties break to the lowest
    id, cool classes take the first free executor."""
    from repro.core import Graph as JGraph
    from repro.core.policies import PolicyContext as JCtx
    from repro_torch.core.policies import PolicyContext as TCtx

    calls = [("g0", (0, 1, 2)), ("g1", (1, 2)), ("e0", (2, 0)), ("m0", (0, 1)),
             ("g2", (0, 1, 2)), ("g3", (2, 1)), ("e1", (1,)), ("m1", (2, 0, 1)), ("g0", ())]
    picks = {}
    for key, (G, Ctx, mod) in {"torch": (Graph, TCtx, thw), "jax": (JGraph, JCtx, jhw)}.items():
        g = G("mixed")
        for name, kind in (("g0", "gemm"), ("g1", "gemm"), ("g2", "gemm"), ("g3", "gemm"),
                           ("e0", "elementwise"), ("e1", "elementwise"),
                           ("m0", "input"), ("m1", "input")):
            g.add_op(name, kind=kind, flops=1e9)
        policy = mod.ContentionAwareCPF(mod.ContentionModel.from_matrix(_matrix(mod),
                                                                        hot_threshold=1.2))
        ctx = Ctx(graph=g, costs={}, levels={}, depths={}, n_executors=3)
        picks[key] = [policy.assign_executor(ctx, op, free) for op, free in calls]
        picks[key].append(sorted(ctx.scratch["contention.exec_class"].items()))
    assert picks["torch"] == picks["jax"]
    assert picks["torch"][:3] == [0, 1, 2]


def test_contention_free_model_is_cpf_exactly():
    g = t_nets.paper_graph("googlenet", "small")
    cfg = {"n_executors": 4, "team_size": 2}
    a = simulate(g, T_KNL, SimConfig(policy="cpf", **cfg))
    b = simulate(g, T_KNL, SimConfig(policy=thw.ContentionAwareCPF(thw.ContentionModel()), **cfg))
    assert [(e.op, e.executor) for e in a.trace] == [(e.op, e.executor) for e in b.trace]


# -- the port's pool, harness and runtime --------------------------------------

def test_pin_pool_pins_port_pool_threads():
    if not thw.affinity_supported():
        pytest.skip("no sched_setaffinity on this platform")
    pool = ExecutorPool(2, device="cpu")
    try:
        plan = thw.plan_pinning(2)
        applied = thw.pin_pool(pool, plan)
        assert applied.pinned and applied.n_threads == 2
        for ex, tid in enumerate(pool.executor_thread_ids()):
            assert os.sched_getaffinity(tid) == set(plan.cpus_for(ex))
    finally:
        pool.close()


def test_pin_pool_rolls_back_on_os_rejection(monkeypatch):
    if not thw.affinity_supported():
        pytest.skip("no sched_setaffinity on this platform")
    pool = ExecutorPool(2, device="cpu")
    calls, restored = {"n": 0}, []
    real = hwpin._set_affinity

    def flaky(tid, cpus):
        calls["n"] += 1
        if calls["n"] == 2:                     # the second executor is rejected
            raise OSError("simulated cpuset rejection")
        restored.append((tid, cpus))
        real(tid, cpus)

    monkeypatch.setattr(hwpin, "_set_affinity", flaky)
    try:
        plan = thw.plan_pinning(2)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            applied = thw.pin_pool(pool, plan)
        assert not applied.pinned and applied.errors
        assert any("OS-scheduled" in str(x.message) for x in w)
        assert calls["n"] == 3                  # the first pin rolled back
        full = tuple(sorted(c.cpu for c in plan.topology.cpus))
        assert restored[-1][1] == full
        assert os.sched_getaffinity(pool.executor_thread_ids()[0]) == set(full)
    finally:
        pool.close()


def test_pin_pool_without_affinity_is_noop_with_one_warning(no_affinity):
    pool = ExecutorPool(2, device="cpu")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            first = thw.pin_pool(pool, thw.plan_pinning(2, thw.synthetic_topology(2)))
            second = thw.pin_pool(pool, thw.plan_pinning(2, thw.synthetic_topology(2)))
            assert not thw.pin_current_thread((0,))
        assert not first.pinned and not second.pinned
        assert len([x for x in w if issubclass(x.category, RuntimeWarning)]) == 1
    finally:
        pool.close()


def test_measure_interference_on_cpu_tensors():
    wls = thw.default_workloads(device="cpu", scale=32)
    assert [w.op_class for w in wls] == ["gemm", "elementwise", "memory"]
    m = thw.measure_interference(wls, thw.synthetic_topology(2), iters=2, repeats=1,
                                 device="cpu")
    assert set(m.classes()) == {"gemm", "elementwise", "memory"}
    assert all(v > 0 for v in m.solo.values()) and len(m.pair) == 9
    assert all(m.slowdown(a, b) >= 1.0 for a in m.classes() for b in m.classes())
    assert m.device == "cpu"
    model = thw.ContentionModel.from_matrix(m)
    assert set(model.pair_slowdown) == set(m.pair)
    unpinned = thw.measure_interference(wls, thw.synthetic_topology(2), iters=1, repeats=1,
                                        pinned=False, device="cpu")
    assert not unpinned.pinned and not unpinned.disjoint


def test_measure_interference_custom_workload_and_failure():
    wl = thw.Workload("custom", lambda: torch.ones(4), lambda s: s * 2)
    m = thw.measure_interference([wl], thw.synthetic_topology(1), iters=1, repeats=1,
                                 device="cpu")
    assert m.classes() == ["custom"] and ("custom", "custom") in m.pair

    def boom(_):
        raise ValueError("bad kernel")

    with pytest.raises(RuntimeError, match="bad kernel"):
        thw.measure_interference([wl, thw.Workload("bad", lambda: None, boom)],
                                 thw.synthetic_topology(2), iters=1, repeats=1, device="cpu")


def test_measure_interference_launch_modes_on_cpu():
    """The CPU feeds its workloads eagerly and keeps each class's host
    seconds; a CUDA graph launch is refused there, as is an unknown mode."""
    wl = thw.Workload("custom", lambda: torch.ones(4), lambda s: s * 2)
    m = thw.measure_interference([wl], thw.synthetic_topology(1), iters=1, repeats=1,
                                 device="cpu")
    assert m.launch == "eager" and set(m.solo_host) == {"custom"} and m.solo_host["custom"] > 0
    for launch in ("graph", "sideways"):
        with pytest.raises(ValueError, match="launch"):
            thw.measure_interference([wl], thw.synthetic_topology(1), iters=1, repeats=1,
                                     device="cpu", launch=launch)


def test_measure_interference_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        thw.measure_interference(device="cuda")


def test_runtime_rejects_bad_pinning_mode():
    with pytest.raises(ValueError, match="pinning"):
        Runtime(2, device="cpu", pinning="sideways")
    with Runtime(2, device="cpu") as rt:
        with pytest.raises(ValueError, match="pinning"):
            rt.set_pinning("sideways")
    assert Runtime.PINNING_MODES == ("off", "auto", "on")


def test_runtime_pinning_auto_is_silent_without_affinity(no_affinity):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with Runtime(2, device="cpu", pinning="auto") as rt:
            rt.pool
            assert rt.pinning_applied is None
    assert not [x for x in w if issubclass(x.category, RuntimeWarning)]


def test_runtime_pinning_on_without_affinity_warns_once_and_executes(no_affinity):
    from repro_torch import api

    def fn(x):
        return torch.tanh(x @ x).sum()

    x = torch.ones(8, 8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with Runtime(2, device="cpu", pinning="on") as rt:
            exe = api.compile(fn, x, backend="host", runtime=rt)
            assert float(exe(x)) == pytest.approx(float(fn(x)))
            assert rt.pinning_applied is not None and not rt.pinning_applied.pinned
            assert "pinning=on:no-op" in rt.describe()
    assert len([x for x in w if issubclass(x.category, RuntimeWarning)]) == 1


def test_runtime_pinning_on_pins_pool_threads():
    if not thw.affinity_supported():
        pytest.skip("no sched_setaffinity on this platform")
    with Runtime(2, device="cpu", pinning="on") as rt:
        tids = rt.pool.executor_thread_ids()
        applied = rt.pinning_applied
        assert applied.pinned and "pinning=on:pinned" in rt.describe()
        for ex, tid in enumerate(tids):
            assert os.sched_getaffinity(tid) == set(applied.plan.cpus_for(ex))


def test_set_pinning_applies_to_a_live_pool_and_compile_kwarg_threads():
    from repro_torch import api

    with Runtime(2, device="cpu") as rt:
        rt.pool
        assert rt.pinning_applied is None
        g = Graph("p")
        g.add_op("a", flops=1e6)
        api.compile(g, backend="sim", runtime=rt, pinning="auto")
        assert rt.pinning == "auto"
        if thw.affinity_supported():
            assert rt.pinning_applied is not None and rt.pinning_applied.pinned


def test_runtime_installs_contention_policy_from_store(tmp_path, clean_policy):
    path = str(tmp_path / "cal.json")
    model = thw.ContentionModel.from_matrix(_matrix(thw))
    CalibrationStore(path).put_interference(model.to_dict())
    with Runtime(2, device="cpu", calibration_path=path) as rt:
        assert "cpf-contention" in list_policies()
        got = rt.contention_model()
        assert got.to_dict() == model.to_dict() and rt.contention_model() is got


def test_runtime_set_contention_model_persists_and_installs(tmp_path, clean_policy):
    path = str(tmp_path / "cal.json")
    model = thw.ContentionModel.from_matrix(_matrix(thw))
    with Runtime(2, device="cpu", calibration_path=path) as rt:
        assert rt.contention_model() is None
        rt.set_contention_model(model)
        assert get_policy("cpf-contention").model is model
    assert CalibrationStore(path).get_interference() == model.to_dict()
    # a store the JAX package wrote loads here, and the reverse
    from repro.runtime import CalibrationStore as JStore

    assert JStore(path).get_interference() == model.to_dict()


def test_cpf_contention_decode_matches_cpf_tokens(clean_policy):
    """A captured decode step compiled under cpf-contention on a runtime
    with a measured model runs the same numbers as under CPF."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.step import make_decode_step

    cfg = get_config("gemma-2b", smoke=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    with Runtime(4, device="cpu") as rt:
        rt.set_contention_model(thw.ContentionModel.from_matrix(_matrix(thw),
                                                                hot_threshold=1.2))
        outs = {}
        for policy in ("cpf", "cpf-contention"):
            exe = api.compile(make_decode_step(cfg), params, cache, tok, runtime=rt,
                              policy=policy, n_executors=4, team_size=1,
                              schedule_search="off")
            assert exe.schedule.policy == policy
            outs[policy] = exe(params, cache, tok)[0]
        assert torch.equal(outs["cpf"], outs["cpf-contention"])


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_serve_cli_takes_pinning(mode, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--continuous",
                       "--requests", "2", "--prompt-len", "8", "--max-new", "2",
                       "--max-batch", "2", "--pinning", mode]) == 0
    out = capsys.readouterr().out
    if thw.affinity_supported():
        assert "pinning: AppliedPinning(pinned" in out


def test_train_cli_takes_pinning(capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "1",
                       "--batch", "2", "--seq", "8", "--log-every", "1",
                       "--pinning", "on"]) == 0
    out = capsys.readouterr().out
    assert "pinning=on" in out and "done: 1 steps" in out
