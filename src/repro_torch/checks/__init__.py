"""``repro_torch.checks`` — the static verifier's structural invariants.

One currency (:class:`Finding` / :class:`Report`, catalog in DESIGN.md
§3.3) over the planning artifacts: the Graph is a DAG with a consistent
successor cache; a Schedule covers every node exactly once, respects dep
edges and never overlaps an executor; a StaticHostPlan's dependency
counters, programs, seeds and poison fan-out are consistent (deadlock
freedom), and concurrent plans' segment submission is FIFO-consistent.
They back ``compile(..., check="basic" | "strict")``.  The JAX package's
effect and hazard analysis reads jaxpr equations and is not ported yet.
"""
from __future__ import annotations

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
]
