"""Structural invariants over the planning artifacts (DESIGN.md §3.3).

One checker per artifact, each returning a :class:`~repro_torch.checks.report.Report`:

* :func:`check_graph`      — G-* rules over the :class:`~repro_torch.core.graph.Graph`
  (acyclicity, dep resolution, successor-cache consistency).
* :func:`check_schedule`   — S-* rules over a :class:`~repro_torch.core.scheduler.Schedule`
  (coverage, dep ordering, executor overlap, executor range).
* :func:`check_plan`       — P-* rules over a :class:`~repro_torch.core.static_host.StaticHostPlan`
  (id maps, coverage, dependency counters vs in-degrees, per-executor
  topological consistency, seed sets, counter-driven reachability — i.e.
  deadlock freedom — poison fan-out, staleness vs ``Graph.version``).
* :func:`check_segment_fifo` — E-FIFO over an :class:`~repro_torch.core.engine.ExecutorPool`
  segment journal: concurrent plans' segments must enqueue in a consistent
  batch order on every executor (verified from evidence, not assumed).

Checkers never raise on a bad artifact — they report.  Callers that want
enforcement use ``Report.raise_if_errors()``.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Mapping, Sequence

from repro_torch.core.graph import Graph
from repro_torch.core.scheduler import Schedule
from repro_torch.core.static_host import StaticHostPlan

from .report import Report

__all__ = [
    "check_graph",
    "check_schedule",
    "check_plan",
    "check_segment_fifo",
    "segment_queues",
]

_EPS = 1e-12
_MAX_PER_RULE = 8   # cap repeated findings of one rule per artifact


def _kahn(nodes: Mapping[str, Sequence[str]]) -> tuple[list[str], list[str]]:
    """(topo order, leftover-in-cycle names) over ``name -> deps``.

    Local to the checker on purpose: ``Graph.topo_order`` raises on a cycle,
    and a verifier must diagnose the broken artifact, not die on it.
    """
    indeg = {n: 0 for n in nodes}
    succs: dict[str, list[str]] = {n: [] for n in nodes}
    for n, deps in nodes.items():
        for d in deps:
            if d in indeg:
                indeg[n] += 1
                succs[d].append(n)
    ready = [n for n, k in indeg.items() if k == 0]
    order: list[str] = []
    while ready:
        n = ready.pop()
        order.append(n)
        for s in succs[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    leftover = [n for n in nodes if indeg[n] > 0]
    return order, leftover


def check_graph(graph: Graph) -> Report:
    """G-* rules: the graph is a resolvable DAG with a fresh successor cache."""
    rep = Report()
    where = graph.name
    names = set(graph.names)

    # G-DEP: every dep names a node of this graph, and not the node itself.
    # Graph.add enforces both, but checkers verify — artifacts can be built
    # by tests, deserialized, or mutated through the private dicts.
    deps_of: dict[str, Sequence[str]] = {}
    n_dep = 0
    for n in graph.names:
        node = graph[n]
        deps_of[n] = node.deps
        for d in node.deps:
            if d == n:
                n_dep += 1
                if n_dep <= _MAX_PER_RULE:
                    rep.add("G-DEP", "error", "node depends on itself",
                            where=where, node=n)
            elif d not in names:
                n_dep += 1
                if n_dep <= _MAX_PER_RULE:
                    rep.add("G-DEP", "error", f"unknown dep {d!r}",
                            where=where, node=n)

    # G-CYCLE: acyclic (Kahn leftover = the nodes on/behind a cycle)
    _, leftover = _kahn(deps_of)
    if leftover:
        rep.add("G-CYCLE", "error",
                f"{len(leftover)} node(s) unreachable under topological "
                f"order (cycle through {sorted(leftover)[:4]})", where=where)

    # G-SUCC: the successor cache agrees with the dep edges (the cache is
    # version-invalidated on add; a stale copy misroutes plan notify edges)
    succ_ref: dict[str, list[str]] = {n: [] for n in graph.names}
    for n, deps in deps_of.items():
        for d in deps:
            if d in succ_ref:
                succ_ref[d].append(n)
    n_succ = 0
    for n in graph.names:
        got = list(graph.successors(n))
        want = succ_ref[n]
        if sorted(got) != sorted(want):
            n_succ += 1
            if n_succ <= _MAX_PER_RULE:
                rep.add("G-SUCC", "error",
                        f"successor cache {got!r} != dep edges {want!r}",
                        where=where, node=n)
    return rep


class _GraphFacts:
    """Per-``Graph.version`` precomputation the plan/schedule checkers
    compare against.  Cached on the graph (like the runtime's artifact
    cache) so ``check="strict"`` re-verification of every plan build pays
    the O(V+E) derivation once per graph version, then C-level tuple
    comparisons per build."""

    __slots__ = ("names", "name_set", "ids", "is_input",
                 "arg_ids", "succ_ids", "n_wait", "input_ids", "topo_names")

    def __init__(self, g: Graph):
        names = tuple(g.names)
        ids = {n: i for i, n in enumerate(names)}
        nodes = [g[n] for n in names]
        self.names = names
        self.name_set = frozenset(names)
        self.ids = ids
        self.is_input = tuple(nd.fn is None for nd in nodes)
        self.arg_ids = tuple(
            tuple(ids.get(d, -1) for d in nd.deps) for nd in nodes)
        self.succ_ids = tuple(
            () if self.is_input[i]
            else tuple(ids[s] for s in g.successors(n))
            for i, n in enumerate(names)
        )
        self.n_wait = tuple(
            sum(1 for j in row if j >= 0 and not self.is_input[j])
            for row in self.arg_ids
        )
        self.input_ids = tuple(
            i for i in range(len(names)) if self.is_input[i])
        # does insertion order witness a topological order (every dep id
        # precedes its consumer)?  Graph.add guarantees it; a graph tampered
        # through the private dicts may not.  True proves acyclicity, which
        # lets check_plan discharge P-REACH/P-TOPO by induction instead of
        # replaying the counter protocol on the clean fast path.
        self.topo_names = all(
            0 <= j < i for i, row in enumerate(self.arg_ids) for j in row)


def _graph_facts(g: Graph) -> _GraphFacts:
    cached = g.__dict__.get("_checks_facts")
    if cached is not None and cached[0] == g.version:
        return cached[1]
    facts = _GraphFacts(g)
    g.__dict__["_checks_facts"] = (g.version, facts)
    return facts


def check_schedule(schedule: Schedule, graph: Graph) -> Report:
    """S-* rules: the schedule covers the graph exactly once and is feasible."""
    rep = Report()
    where = f"{graph.name}/{schedule.policy}"
    facts = _graph_facts(graph)
    pl = schedule.placements

    # S-COVER: every node exactly once, nothing foreign
    if pl.keys() != facts.name_set:
        placed = set(pl)
        for n in sorted(facts.name_set - placed)[:_MAX_PER_RULE]:
            rep.add("S-COVER", "error", "node missing from schedule",
                    where=where, node=n)
        for n in sorted(placed - facts.name_set)[:_MAX_PER_RULE]:
            rep.add("S-COVER", "error", "scheduled op not in graph",
                    where=where, node=n)

    # S-EXEC / S-OVERLAP detection: one C-level sort of the placement rows
    # by (executor, start); the executor range falls out of the sorted ends
    # and overlap is a single adjacent-pair pass.  The named per-node
    # diagnosis below only runs when a violation is detected.
    width = schedule.n_executors
    rows = sorted(pl.values())
    exec_bad = bool(rows) and (rows[0][0] < 0 or rows[-1][0] >= width)
    ovl_bad = any(a[0] == b[0] and a[2] > b[1] + _EPS
                  for a, b in zip(rows, rows[1:]))

    if exec_bad:
        n_exec = 0
        for n, (e, _, _) in pl.items():
            if not 0 <= e < width:
                n_exec += 1
                if n_exec <= _MAX_PER_RULE:
                    rep.add("S-EXEC", "error",
                            f"executor {e} outside [0, {width})",
                            where=where, node=n, executor=e)

    # S-DEP: every dep finishes before its consumer starts.  Placements are
    # fetched once into an id-aligned list so the per-edge loop is list
    # indexing, not dict hashing.
    get = pl.get
    recs = [get(n) for n in facts.names]
    n_dep = 0
    for i, row in enumerate(facts.arg_ids):
        if not row:
            continue
        rec = recs[i]
        if rec is None:
            continue    # already an S-COVER error
        start = rec[1] + _EPS
        for j in row:
            drec = recs[j] if j >= 0 else None   # j < 0: G-DEP's problem
            if drec is not None and drec[2] > start:
                n_dep += 1
                if n_dep <= _MAX_PER_RULE:
                    rep.add("S-DEP", "error",
                            f"starts at {rec[1]:.3e} before dep "
                            f"{facts.names[j]!r} ends at {drec[2]:.3e}",
                            where=where, node=facts.names[i])

    # S-OVERLAP diagnosis: one op at a time per executor
    if ovl_bad:
        per_exec: dict[int, list[tuple[float, float, str]]] = {}
        for n, (e, s, t) in pl.items():
            per_exec.setdefault(e, []).append((s, t, n))
        n_ovl = 0
        for e, iv in sorted(per_exec.items()):
            iv.sort()
            for (s0, t0, a), (s1, t1, b) in zip(iv, iv[1:]):
                if t0 > s1 + _EPS:
                    n_ovl += 1
                    if n_ovl <= _MAX_PER_RULE:
                        rep.add("S-OVERLAP", "error",
                                f"{a!r} [{s0:.3e},{t0:.3e}] overlaps {b!r} "
                                f"[{s1:.3e},{t1:.3e}]",
                                where=where, executor=e)
    return rep


def check_plan(plan: StaticHostPlan, graph: Graph | None = None) -> Report:
    """P-* rules over a compiled static host plan.

    Verifies the frozen integer-id artifact against the graph it claims to
    execute: a wrong dependency counter deadlocks a run (too high) or races
    an op before its inputs exist (too low); a wrong owner or missing notify
    edge strands a segment forever.  ``graph`` defaults to ``plan.graph``.
    """
    rep = Report()
    g = graph if graph is not None else plan.graph
    where = f"{g.name}/plan{plan.n_executors}"

    # P-STALE: the plan was compiled against this exact graph version
    if plan.graph_version != g.version:
        rep.add("P-STALE", "error",
                f"plan compiled at graph version {plan.graph_version}, "
                f"graph is at {g.version} — recompile", where=where)
        return rep      # id maps below are meaningless against a mutated graph

    # the expected graph-derived half of the plan (names/ids/arg_ids/
    # succ_ids/n_wait/input_ids) is cached per graph version; the fast path
    # is one C-level tuple comparison per field, and the per-node diagnostic
    # loops below only run when a comparison fails — this is what keeps
    # check="strict" inside its <10% plan-build budget
    facts = _graph_facts(g)
    n_nodes = len(facts.names)
    is_input = facts.is_input

    # P-IDS: names/ids are a bijection mirroring the graph
    if tuple(plan.names) != facts.names:
        rep.add("P-IDS", "error",
                f"plan names ({len(plan.names)}) != graph names "
                f"({len(g)})", where=where)
        return rep
    if dict(plan.ids) != facts.ids:
        for n, i in plan.ids.items():
            if not (0 <= i < n_nodes) or plan.names[i] != n:
                rep.add("P-IDS", "error",
                        f"ids[{n!r}]={i} does not invert names",
                        where=where, node=n)
                return rep

    # does the plan's graph-derived half mirror the cached facts exactly?
    # (used below to discharge P-TOPO/P-REACH by induction on the clean path)
    mirror_ok = (plan.arg_ids == facts.arg_ids
                 and plan.succ_ids == facts.succ_ids
                 and plan.n_wait == facts.n_wait)

    # P-COVER: owner/programs partition exactly the executed (non-input) ops
    owner = plan.owner
    seen = [-1] * n_nodes
    n_dup = 0
    for e, prog in enumerate(plan.programs):
        for i in prog:
            if seen[i] >= 0:
                n_dup += 1
                rep.add("P-COVER", "error",
                        f"op in programs of executors {seen[i]} and {e}",
                        where=where, node=plan.names[i], executor=e)
            seen[i] = e
            if owner[i] != e:
                rep.add("P-COVER", "error",
                        f"owner {owner[i]} != program executor {e}",
                        where=where, node=plan.names[i], executor=e)
    # no duplicates and a matching placement count ⇒ programs hold exactly
    # the executed ops iff no input was placed; the per-node scan only runs
    # when the counts disagree
    n_placed = sum(len(prog) for prog in plan.programs) - n_dup
    if n_placed != n_nodes - len(facts.input_ids) or \
            any(seen[i] >= 0 for i in facts.input_ids):
        for i in range(n_nodes):
            if is_input[i]:
                if seen[i] >= 0:
                    rep.add("P-COVER", "error",
                            "input node appears in a program",
                            where=where, node=plan.names[i])
            elif seen[i] < 0:
                rep.add("P-COVER", "error",
                        "executed op missing from programs",
                        where=where, node=plan.names[i])
    if plan.input_ids != facts.input_ids and \
            set(plan.input_ids) != set(facts.input_ids):
        rep.add("P-COVER", "error", "input_ids != fn-less nodes", where=where)

    # P-ARGS: argument ids and notify edges mirror the graph's dep edges
    if plan.arg_ids != facts.arg_ids:
        for i in range(n_nodes):
            if plan.arg_ids[i] != facts.arg_ids[i]:
                rep.add("P-ARGS", "error",
                        f"arg_ids {plan.arg_ids[i]} != deps "
                        f"{facts.arg_ids[i]}",
                        where=where, node=plan.names[i])
    if plan.succ_ids != facts.succ_ids:
        n_succ = 0
        for i in range(n_nodes):
            if set(plan.succ_ids[i]) != set(facts.succ_ids[i]):
                n_succ += 1
                if n_succ <= _MAX_PER_RULE:
                    rep.add("P-ARGS", "error",
                            f"succ_ids {sorted(plan.succ_ids[i])} != "
                            f"consumers {sorted(facts.succ_ids[i])}",
                            where=where, node=plan.names[i])

    # P-COUNTER: each counter target equals the executed-dep in-degree
    if plan.n_wait != facts.n_wait:
        for i in range(n_nodes):
            got, want = plan.n_wait[i], facts.n_wait[i]
            if got != want:
                rep.add("P-COUNTER", "error",
                        f"dependency counter {got} != executed "
                        f"in-degree {want} — run would "
                        + ("deadlock" if got > want
                           else "fire before its inputs exist"),
                        where=where, node=plan.names[i])

    # P-SEED: seeds are exactly the zero-wait ops of each program
    n_wait = plan.n_wait
    for e, prog in enumerate(plan.programs):
        want_seed = tuple(i for i in prog if n_wait[i] == 0)
        if tuple(plan.seeds[e]) != want_seed:
            rep.add("P-SEED", "error",
                    f"seeds {plan.seeds[e]} != zero-wait program ops "
                    f"{want_seed}", where=where, executor=e)

    # P-TOPO: no program lists an op after one of its dependents — the
    # frozen order must embed the dependency partial order per executor.
    # Fast path: when the plan mirrors the facts and insertion order is
    # topological (every edge points small id -> large id), a strictly
    # ascending program cannot invert an edge; only non-ascending programs
    # pay the per-edge scan.
    succ_ids = plan.succ_ids
    topo_fast = mirror_ok and facts.topo_names
    pos: list[int] | None = None
    n_topo = 0
    for e, prog in enumerate(plan.programs):
        if topo_fast and all(a < b for a, b in zip(prog, prog[1:])):
            continue
        if pos is None:
            pos = [-1] * n_nodes
            for p in plan.programs:
                for k, i in enumerate(p):
                    pos[i] = k
        for i in prog:
            pi = pos[i]
            for s in succ_ids[i]:
                if owner[s] == e and 0 <= pos[s] < pi:
                    n_topo += 1
                    if n_topo <= _MAX_PER_RULE:
                        rep.add("P-TOPO", "error",
                                f"program lists {plan.names[s]!r} before its "
                                f"dep {plan.names[i]!r}", where=where,
                                executor=e)

    # P-REACH: every op must fire under the counter protocol — the
    # deadlock-freedom proof of the plan *as compiled*.  When the plan
    # mirrors the facts exactly, the graph is provably acyclic
    # (facts.topo_names), and coverage/seeds checked clean, reachability
    # follows by induction over the topological order (each op's counter
    # target equals its executed in-degree and every producer notifies it),
    # so the replay is skipped.  Any mismatch or prior finding forces the
    # full replay, which re-detects a dropped counter or notify edge as the
    # op that never becomes ready.
    if not (mirror_ok and facts.topo_names and not rep.findings):
        fired = [False] * n_nodes
        count = [0] * n_nodes
        stack = [i for seed in plan.seeds for i in seed]
        while stack:
            i = stack.pop()
            if fired[i]:
                continue
            fired[i] = True
            for s in succ_ids[i]:
                count[s] += 1
                if count[s] >= n_wait[s]:
                    stack.append(s)
        stranded = [i for i in range(n_nodes)
                    if seen[i] >= 0 and not fired[i]]
        for i in stranded[:_MAX_PER_RULE]:
            rep.add("P-REACH", "error",
                    f"never becomes ready (counter target {n_wait[i]}, "
                    f"notifiers deliver {count[i]}) — executor "
                    f"{owner[i]}'s segment would deadlock",
                    where=where, node=plan.names[i], executor=owner[i])

    # P-POISON: the failure protocol must reach every segment — one ready
    # queue per executor in [0, n_executors), every owner in range, so
    # ``_PlanRun.fail`` poisons each segment's blocking ``get``
    if len(plan.programs) != plan.n_executors or \
            len(plan.seeds) != plan.n_executors:
        rep.add("P-POISON", "error",
                f"{len(plan.programs)} programs / {len(plan.seeds)} seed "
                f"sets for {plan.n_executors} executors — failure poison "
                "cannot reach every segment", where=where)
    # owner entries are -1 (input) or an executor id; min/max are C-level,
    # the per-node scan only runs when the range check trips
    n_execs = plan.n_executors
    if n_nodes and (min(owner) < -1 or max(owner) >= n_execs):
        for i in range(n_nodes):
            if seen[i] >= 0 and not 0 <= owner[i] < n_execs:
                rep.add("P-POISON", "error",
                        f"owner {owner[i]} outside [0, {n_execs})",
                        where=where, node=plan.names[i])
                break
    return rep


def segment_queues(
    log: Iterable[tuple[int, int, str]],
) -> dict[int, list[int]]:
    """Per-executor submission-batch order from an
    :class:`~repro_torch.core.engine.ExecutorPool` ``segment_log``.

    The journal records ``(executor, batch, segment_name)`` per enqueued
    segment, in enqueue order, under the pool's segment lock.
    """
    queues: dict[int, list[int]] = {}
    for e, batch, _name in log:
        queues.setdefault(e, []).append(batch)
    return queues


def check_segment_fifo(
    queues: Mapping[int, Sequence[int]] | Iterable[tuple[int, int, str]],
) -> Report:
    """E-FIFO: concurrent plans' segments are FIFO-consistent across executors.

    ``submit_segments`` enqueues a whole plan's segments atomically, so the
    *batch precedence* relation observed on the executors — batch a precedes
    batch b if some executor queue holds an ``a`` segment before a ``b``
    segment — must be acyclic; a cycle means two runs would each wait on an
    executor the other holds (the deadlock the segment lock exists to
    prevent).  Accepts either the per-executor queues or a raw
    ``segment_log``.  Also flags a batch enqueued twice on one executor.
    """
    rep = Report()
    if not isinstance(queues, Mapping):
        queues = segment_queues(queues)

    edges: dict[int, set[int]] = {}
    for e, q in sorted(queues.items()):
        seen: set[int] = set()
        for a, b in zip(q, q[1:]):
            if a != b:
                edges.setdefault(a, set()).add(b)
        for batch in q:
            if batch in seen:
                rep.add("E-FIFO", "error",
                        f"batch {batch} enqueued twice on one executor",
                        executor=e)
            seen.add(batch)

    # cycle detection over the precedence relation (iterative 3-color DFS)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[int, int] = {}
    for root in edges:
        if color.get(root, WHITE) != WHITE:
            continue
        stack: list[tuple[int, Iterator]] = [(root, iter(edges.get(root, ())))]
        color[root] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    rep.add("E-FIFO", "error",
                            f"segment batches {node} and {nxt} enqueued in "
                            "opposite orders on different executors — "
                            "cross-plan deadlock")
                    continue
                if c == WHITE:
                    color[nxt] = GRAY
                    stack.append((nxt, iter(edges.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
    if rep.ok and queues:
        n_seg = sum(len(q) for q in queues.values())
        rep.add("E-FIFO", "info",
                f"{n_seg} segment enqueues over {len(queues)} executors: "
                "batch order consistent")
    return rep
