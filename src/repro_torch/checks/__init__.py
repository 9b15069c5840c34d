"""``repro_torch.checks`` — static verifier & concurrency-hazard analysis.

Three layers over one currency (:class:`Finding` / :class:`Report`,
catalog in DESIGN.md §3.3):

1. **Structural invariants** (:mod:`.invariants`) — the Graph is a DAG with
   a consistent successor cache; a Schedule covers every node exactly once,
   respects dep edges, and never overlaps an executor; a StaticHostPlan's
   dependency counters equal executed in-degrees, its per-executor programs
   are topologically consistent, every op is reachable from the seeds under
   the counter protocol (deadlock freedom), the poison failure protocol can
   reach every segment, and concurrent plans' segment submission is
   FIFO-consistent — replayed from pool evidence, not assumed.
2. **Effect & hazard analysis** (:mod:`.effects`, :mod:`.hazards`) — per-node
   read/write buffer sets traced from the captured fx nodes, happens-before
   from dep edges (plus executor program order when a schedule is given),
   unordered write/write and read/write pairs flagged; cross-graph
   conflicts over aliased buffers (the paged pools) reported by
   :func:`cross_graph_hazards`.
3. **Source rules** (:mod:`.assertscan`) — W-ASSERT keeps bare ``assert``
   statements out of library code.

Entry points: ``Executable.verify()`` and ``repro_torch.compile(...,
check=)`` for in-process use; ``python -m repro_torch.checks --zoo`` for the
config-zoo sweep; the serving CLI's ``--check``.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph
from repro_torch.core.scheduler import Schedule
from repro_torch.core.static_host import StaticHostPlan

from .assertscan import scan_asserts
from .effects import GraphEffects, NodeEffects, infer_effects, shared_buffers
from .hazards import check_hazards, cross_graph_hazards
from .invariants import (check_graph, check_plan, check_schedule,
                         check_segment_fifo, segment_queues)
from .report import SEVERITIES, Finding, Report

__all__ = [
    "Finding",
    "Report",
    "SEVERITIES",
    "check_graph",
    "check_schedule",
    "check_plan",
    "check_segment_fifo",
    "segment_queues",
    "NodeEffects",
    "GraphEffects",
    "infer_effects",
    "shared_buffers",
    "check_hazards",
    "cross_graph_hazards",
    "scan_asserts",
    "verify_all",
]


def verify_all(
    graph: Graph,
    schedule: Schedule | None = None,
    plan: StaticHostPlan | None = None,
    *,
    hazards: bool = True,
) -> Report:
    """Run every applicable checker over one graph's planning artifacts."""
    rep = check_graph(graph)
    if schedule is not None:
        rep.extend(check_schedule(schedule, graph))
    if plan is not None:
        rep.extend(check_plan(plan, graph))
    if hazards:
        rep.extend(check_hazards(graph, schedule=schedule))
    return rep
