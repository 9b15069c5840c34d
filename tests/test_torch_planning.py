"""The port's planning layer against the JAX package's on the same graphs.

Each package builds its own copy of every graph (``static_host.layered_graph``
and the paper nets of ``models.paper_nets``).  Every registered policy must
give the same start order and makespan in both packages, and the structural
checkers the same findings.  Planning is exact arithmetic on the same floats:
no tolerance.
"""
import pytest

from repro.core import cost_model as j_cost
from repro.core import scheduler as j_sched
from repro.core.static_host import layered_graph as j_layered
from repro.models.paper_nets import paper_graph as j_paper_graph
from repro_torch.checks import check_graph, check_schedule
from repro_torch.core import cost_model as t_cost
from repro_torch.core import scheduler as t_sched
from repro_torch.core.graph import OpNode
from repro_torch.core.policies import list_policies
from repro_torch.core.profiler import profile
from repro_torch.core.search import search_schedule
from repro_torch.core.static_host import compile_host_plan, layered_graph
from repro_torch.models.paper_nets import paper_graph

# graph -> (the reference's constructor, the port's)
GRAPHS = {
    "layered": (j_layered, layered_graph),
    **{net: (lambda net=net: j_paper_graph(net, "small"),
             lambda net=net: paper_graph(net, "small"))
       for net in ("lstm", "phased_lstm", "pathnet", "googlenet")},
}
POLICIES = ["cpf", "level-pack", "lpt", "cpf-perturb"]


def _graphs(name: str):
    """(reference graph, port graph), each built by its own package."""
    j_build, t_build = GRAPHS[name]
    return j_build(), t_build()


def _order(sched):
    return [(n, sched.placements[n]) for n in sched.start_order()]


def test_policy_registry_matches_reference():
    from repro.core.policies import list_policies as j_list

    assert list_policies() == j_list() == POLICIES


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_schedule_matches_reference(graph, policy):
    jg, g = _graphs(graph)
    js = j_sched.make_schedule(jg, j_cost.KNL7250, n_executors=4, team_size=16, policy=policy)
    ts = t_sched.make_schedule(g, t_cost.KNL7250, n_executors=4, team_size=16, policy=policy)
    assert ts.makespan == js.makespan
    assert _order(ts) == _order(js)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_checker_findings_match_reference(graph):
    from repro.checks import check_graph as j_check_graph
    from repro.checks import check_schedule as j_check_schedule

    jg, g = _graphs(graph)
    js = j_sched.make_schedule(jg, j_cost.KNL7250, n_executors=4, team_size=16)
    ts = t_sched.make_schedule(g, t_cost.KNL7250, n_executors=4, team_size=16)
    assert [str(f) for f in check_graph(g)] == [str(f) for f in j_check_graph(jg)]
    assert ([str(f) for f in check_schedule(ts, g)]
            == [str(f) for f in j_check_schedule(js, jg)])


@pytest.mark.parametrize("graph", ["layered", "pathnet"])
def test_profile_and_search_match_reference(graph):
    from repro.core.profiler import profile as j_profile
    from repro.core.search import search_schedule as j_search

    jg, g = _graphs(graph)
    jp = j_profile(jg, j_cost.KNL7250, n_workers=64)
    tp = profile(g, t_cost.KNL7250, n_workers=64)
    assert tp.config_makespans == jp.config_makespans
    assert tp.best_config == jp.best_config
    jr = j_search(jg, j_cost.KNL7250, n_executors=4, team_size=16)
    tr = search_schedule(g, t_cost.KNL7250, n_executors=4, team_size=16)
    assert (tr.policy, tr.seed, tr.makespan_sim) == (jr.policy, jr.seed, jr.makespan_sim)


def test_h100_model_is_the_card():
    hw = t_cost.H100
    assert hw.n_workers == 132
    assert hw.peak_flops * hw.n_workers == pytest.approx(989e12)
    assert hw.mem_bw_total == 3.35e12
    # a launch is the floor of any op
    assert t_cost.op_time(hw, OpNode("x"), 1) == hw.dispatch_alpha


def test_static_plan_runs_layered_graph_like_execute():
    g = layered_graph()
    sched = t_sched.make_schedule(g, t_cost.KNL7250, n_executors=3, team_size=1)
    plan = compile_host_plan(g, sched)
    assert plan.run({"x": 1.0}).outputs["out"] == g.execute({"x": 1.0})["out"]
    assert plan.cross == tuple(
        any(plan.owner[s] != plan.owner[i] for s in plan.succ_ids[i])
        for i in range(len(plan.names)))


def test_calibration_store_and_signature_interoperate(tmp_path):
    from repro.runtime import CalibrationStore as JStore
    from repro.runtime import graph_signature as j_signature
    from repro_torch.runtime import CalibrationStore, graph_signature

    jg, g = _graphs("pathnet")
    sig = graph_signature(g)
    assert sig == j_signature(jg)
    path = str(tmp_path / "cal.json")
    js = JStore(path)
    js.put(sig, {n: 1e-6 * (i + 1) for i, n in enumerate(jg.names)})
    js.put_schedule(sig, "4x16|analytic", {"policy": "lpt", "seed": 0, "makespan_sim": 1.0,
                                           "runner_up_gap": 0.0})
    store = CalibrationStore(path)               # the port reads the reference's file
    assert store.get(sig) == js.get(sig)
    assert store.get_schedule(sig, "4x16|analytic")["policy"] == "lpt"
    store.put(sig, {n: 2e-6 for n in g.names})   # and writes one the reference reads
    assert JStore(path).get(sig) == {n: 2e-6 for n in g.names}
