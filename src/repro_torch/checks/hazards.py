"""Concurrency-hazard analysis over buffer effects (DESIGN.md §3.3).

Within one graph, the only ordering the runtimes *guarantee* is the dep
edges: the dynamic scheduler and the static host plan both run any two
dep-unordered ops concurrently whenever executors are free.  So two ops
touching the same buffer with at least one writer must be ordered by a dep
path, or the run is a data race:

* **H-WW** (error) — two writes to one buffer with no dep path between them;
* **H-RW** (error) — a read and a write unordered by deps.

When a schedule is supplied, a pair that *is* serialized by landing on the
same executor (program order) — but not by deps — downgrades to a warning:
today's placement hides the race, the next profile re-plan may not.

Across graphs there is no dep order at all; :func:`cross_graph_hazards`
takes two :class:`~repro_torch.checks.effects.GraphEffects` plus the buffer alias
pairs (:func:`~repro_torch.checks.effects.shared_buffers`) and reports:

* **H-XWW** (error) — both graphs write a shared buffer: never safe to run
  concurrently;
* **H-XRW** (info)  — one writes, the other only reads: safe exactly when
  the caller serializes the runs externally (the paged serving engine's
  insert-after-decode protocol), which is why chunked-prefill graphs must
  stay read-only over the pools — the certification this rule states.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from repro_torch.core.graph import Graph
from repro_torch.core.scheduler import Schedule

from .effects import GraphEffects, infer_effects
from .report import Report

__all__ = ["check_hazards", "cross_graph_hazards"]

_MAX_PER_RULE = 8


def _descendant_bits(
    order: list[str],
    succs: Mapping[str, Iterable[str]],
) -> dict[str, int]:
    """Per-node descendant set (self included) as int bitmasks over a topo
    order — reflexive-transitive closure in O(V·E/word)."""
    idx = {n: i for i, n in enumerate(order)}
    reach: dict[str, int] = {}
    for n in reversed(order):
        bits = 1 << idx[n]
        for s in succs.get(n, ()):
            bits |= reach[s]
        reach[n] = bits
    return reach


def _topo(names: Iterable[str], succs: Mapping[str, Iterable[str]]) -> list[str] | None:
    names = list(names)
    indeg = {n: 0 for n in names}
    for n in names:
        for s in succs.get(n, ()):
            indeg[s] += 1
    ready = [n for n in names if indeg[n] == 0]
    order: list[str] = []
    while ready:
        n = ready.pop()
        order.append(n)
        for s in succs.get(n, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    return order if len(order) == len(names) else None


def check_hazards(
    graph: Graph,
    effects: GraphEffects | None = None,
    schedule: Schedule | None = None,
) -> Report:
    """H-* rules: unordered same-buffer access pairs within one graph."""
    rep = Report()
    where = graph.name
    if effects is None:
        effects = infer_effects(graph)
    if effects.version != graph.version:
        rep.add("H-STALE", "error",
                f"effects inferred at graph version {effects.version}, graph "
                f"is at {graph.version} — re-run infer_effects", where=where)
        return rep

    names = list(graph.names)
    dep_succs = {n: tuple(graph.successors(n)) for n in names}
    order = _topo(names, dep_succs)
    if order is None:
        rep.add("H-ORDER", "error",
                "graph is cyclic — hazard analysis needs check_graph to pass",
                where=where)
        return rep
    idx = {n: i for i, n in enumerate(order)}
    dep_reach = _descendant_bits(order, dep_succs)

    sched_reach: dict[str, int] | None = None
    if schedule is not None:
        # program order on one executor serializes its ops even without deps.
        # Input nodes (no fn: the buffers themselves) run on no executor; a
        # schedule places them at zero duration, and its start-order tie
        # break by name can put one after its consumer
        both = {n: set(dep_succs[n]) for n in names}
        for ops in schedule.by_executor():
            placed = [n for n in ops if n in both and graph[n].fn is not None]
            for a, b in zip(placed, placed[1:]):
                both[a].add(b)
        sorder = _topo(names, both)
        if sorder is None:
            rep.add("H-ORDER", "error",
                    "schedule executor order contradicts dep edges "
                    "(check_schedule S-DEP) — placement serialization ignored",
                    where=where)
        else:
            sched_reach = _descendant_bits(sorder, both)

    def ordered(reach: Mapping[str, int], a: str, b: str) -> bool:
        return bool(reach[a] >> idx[b] & 1) or bool(reach[b] >> idx[a] & 1)

    counts = {"H-WW": 0, "H-RW": 0}

    def emit(rule: str, a: str, b: str, buf: str, kind: str) -> None:
        counts[rule] += 1
        if counts[rule] > _MAX_PER_RULE:
            return
        if sched_reach is not None and ordered(sched_reach, a, b):
            rep.add(rule, "warning",
                    f"{kind} of buffer {buf!r} by {a!r} and {b!r} is "
                    "serialized only by executor placement — a re-profile "
                    "can reorder it", where=where, node=a)
        else:
            rep.add(rule, "error",
                    f"unordered {kind} of buffer {buf!r}: no dep path "
                    f"between {a!r} and {b!r}", where=where, node=a)

    for buf in sorted(effects.written()):
        writers = sorted(effects.writers(buf), key=idx.__getitem__)
        readers = sorted(effects.readers(buf), key=idx.__getitem__)
        for i, a in enumerate(writers):
            for b in writers[i + 1:]:
                if not ordered(dep_reach, a, b):
                    emit("H-WW", a, b, buf, "write/write")
            for b in readers:
                if not ordered(dep_reach, a, b):
                    emit("H-RW", a, b, buf, "read/write")
    for rule, n in counts.items():
        if n > _MAX_PER_RULE:
            rep.add(rule, "info",
                    f"{n - _MAX_PER_RULE} further {rule} pairs suppressed",
                    where=where)
    return rep


def cross_graph_hazards(
    eff_a: GraphEffects,
    eff_b: GraphEffects,
    shared: Iterable[tuple[str, str]],
) -> Report:
    """H-X* rules: conflicting access to buffers aliased across two graphs."""
    rep = Report()
    where = f"{eff_a.graph_name}×{eff_b.graph_name}"
    wrote_a = eff_a.written()
    wrote_b = eff_b.written()
    n_shared = 0
    for buf_a, buf_b in shared:
        n_shared += 1
        a_w, b_w = buf_a in wrote_a, buf_b in wrote_b
        if a_w and b_w:
            rep.add("H-XWW", "error",
                    f"both graphs write shared buffer ({buf_a!r} in "
                    f"{eff_a.graph_name!r}, {buf_b!r} in "
                    f"{eff_b.graph_name!r}) — concurrent runs race",
                    where=where, node=buf_a)
        elif a_w or b_w:
            writer = eff_a.graph_name if a_w else eff_b.graph_name
            rep.add("H-XRW", "info",
                    f"shared buffer {buf_a!r}/{buf_b!r} written by "
                    f"{writer!r} only — concurrent runs need external "
                    "serialization of the write", where=where, node=buf_a)
    if n_shared and rep.ok:
        rep.add("H-XOK", "info",
                f"{n_shared} shared buffer(s), no write/write conflicts",
                where=where)
    return rep
