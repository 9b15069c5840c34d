"""Computation-graph IR for the Graphi scheduling engine.

A :class:`Graph` is a DAG of :class:`OpNode`. Nodes carry the roofline-relevant
statistics (flops / bytes in / bytes out) that the cost model consumes, plus an
optional ``fn`` so the host engine can actually *execute* the graph (fn takes
the dep outputs in ``deps`` order and returns this node's output).

This mirrors the paper's abstraction (Section 2): nodes are operations
(GEMM / conv / elementwise / ...), edges are data dependencies.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping, Sequence

__all__ = ["OpNode", "Graph", "GraphValidationError"]


class GraphValidationError(ValueError):
    pass


@dataclass(frozen=True)
class OpNode:
    """One operation in the computation graph."""

    name: str
    kind: str = "generic"  # gemm | elementwise | conv | attention | scan | ...
    flops: float = 0.0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    deps: tuple[str, ...] = ()
    meta: Mapping[str, Any] = field(default_factory=dict)
    fn: Callable[..., Any] | None = None

    @property
    def bytes_total(self) -> float:
        return self.bytes_in + self.bytes_out

    def with_deps(self, deps: Sequence[str]) -> "OpNode":
        return replace(self, deps=tuple(deps))


class Graph:
    """Directed acyclic computation graph (insertion-ordered)."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self._nodes: dict[str, OpNode] = {}
        self._succs: dict[str, list[str]] = {}
        self._succ_tuples: dict[str, tuple[str, ...]] = {}
        self._version = 0
        self._succ_version = 0

    # -- construction ------------------------------------------------------
    def add(self, node: OpNode) -> OpNode:
        if node.name in self._nodes:
            raise GraphValidationError(f"duplicate node {node.name!r}")
        for d in node.deps:
            if d not in self._nodes:
                raise GraphValidationError(
                    f"node {node.name!r} depends on unknown node {d!r}"
                )
        self._nodes[node.name] = node
        self._succs[node.name] = []
        for d in node.deps:
            self._succs[d].append(node.name)
        self._version += 1
        return node

    @property
    def version(self) -> int:
        """Mutation counter, bumped on every :meth:`add`.

        The single staleness guard for everything derived from the graph's
        structure: cached successor tuples, :class:`HostScheduler` hoisted
        immutables, compiled :class:`StaticHostPlan`\\ s, and
        ``repro_torch.checks`` analyses all record the version they were built
        against and refuse (or rebuild) when the graph has grown since.
        """
        return self._version

    def add_op(self, name: str, **kw: Any) -> OpNode:
        deps = tuple(kw.pop("deps", ()))
        return self.add(OpNode(name=name, deps=deps, **kw))

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __getitem__(self, name: str) -> OpNode:
        return self._nodes[name]

    @property
    def nodes(self) -> list[OpNode]:
        return list(self._nodes.values())

    @property
    def names(self) -> list[str]:
        return list(self._nodes)

    def successors(self, name: str) -> tuple[str, ...]:
        """Consumers of ``name`` as a cached immutable tuple.

        Hit once per op per run by every runtime (dynamic scheduler,
        simulator, plan compiler) — a fresh list copy per call was pure
        per-op overhead.  The cache invalidates via :attr:`version`.
        """
        if self._succ_version != self._version:
            self._succ_tuples.clear()
            self._succ_version = self._version
        t = self._succ_tuples.get(name)
        if t is None:
            t = self._succ_tuples[name] = tuple(self._succs[name])
        return t

    def predecessors(self, name: str) -> tuple[str, ...]:
        """Dependencies of ``name`` — the node's own (immutable) dep tuple."""
        return self._nodes[name].deps

    def in_degree(self, name: str) -> int:
        return len(self._nodes[name].deps)

    def sources(self) -> list[str]:
        return [n for n in self._nodes if not self._nodes[n].deps]

    def sinks(self) -> list[str]:
        return [n for n in self._nodes if not self._succs[n]]

    def total_flops(self) -> float:
        return sum(n.flops for n in self._nodes.values())

    def total_bytes(self) -> float:
        return sum(n.bytes_total for n in self._nodes.values())

    # -- orderings & structure ----------------------------------------------
    def topo_order(self) -> list[str]:
        """Kahn topological order (deterministic: insertion-order tiebreak)."""
        indeg = {n: self.in_degree(n) for n in self._nodes}
        order_index = {n: i for i, n in enumerate(self._nodes)}
        ready: list[tuple[int, str]] = [
            (order_index[n], n) for n, d in indeg.items() if d == 0
        ]
        heapq.heapify(ready)
        out: list[str] = []
        while ready:
            _, n = heapq.heappop(ready)
            out.append(n)
            for s in self._succs[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, (order_index[s], s))
        if len(out) != len(self._nodes):
            raise GraphValidationError(f"graph {self.name!r} has a cycle")
        return out

    def validate(self) -> None:
        self.topo_order()  # raises on cycles

    def depth_levels(self) -> dict[str, int]:
        """Unit-cost longest path *from sources* (the ASAP wave index)."""
        lev: dict[str, int] = {}
        for n in self.topo_order():
            node = self._nodes[n]
            lev[n] = 0 if not node.deps else 1 + max(lev[d] for d in node.deps)
        return lev

    def width(self) -> int:
        """Parallelism width: max #ops sharing an ASAP wave (antichain lower
        bound — matches the paper's 'number of parallelizable operations')."""
        lev = self.depth_levels()
        counts: dict[int, int] = {}
        for v in lev.values():
            counts[v] = counts.get(v, 0) + 1
        return max(counts.values()) if counts else 0

    def levels(self, costs: Mapping[str, float]) -> dict[str, float]:
        """Paper §4.3 *level* value: longest accumulated cost from the op to
        the sink, **inclusive** of the op itself."""
        lev: dict[str, float] = {}
        for n in reversed(self.topo_order()):
            succ = self._succs[n]
            tail = max((lev[s] for s in succ), default=0.0)
            lev[n] = costs[n] + tail
        return lev

    def critical_path(self, costs: Mapping[str, float]) -> tuple[float, list[str]]:
        """(length, node list) of the longest-cost path source→sink.

        The maximum level is always attained at a source (levels are
        non-increasing along edges), and the path follows max-level
        successors all the way to a sink — zero-cost tail ops (a free
        concat/loss node) are still on the path.
        """
        lev = self.levels(costs)
        if not self._nodes:
            return 0.0, []
        cur = max(self.sources(), key=lambda n: lev[n])
        path = [cur]
        while self._succs[cur]:
            cur = max(self._succs[cur], key=lambda s: lev[s])
            path.append(cur)
        return lev[path[0]], path

    # -- execution ----------------------------------------------------------
    def execute(self, inputs: Mapping[str, Any] | None = None) -> dict[str, Any]:
        """Reference sequential interpreter (topological order).

        Source nodes take their value from ``inputs[name]`` if given, else
        ``fn()`` with no args. Used as the correctness oracle for every
        parallel execution path.
        """
        inputs = dict(inputs or {})
        out: dict[str, Any] = {}
        for n in self.topo_order():
            node = self._nodes[n]
            if not node.deps and n in inputs:
                out[n] = inputs[n]
            elif node.fn is None:
                raise GraphValidationError(f"node {n!r} has no fn and no input")
            else:
                out[n] = node.fn(*[out[d] for d in node.deps])
        return out

    # -- misc ----------------------------------------------------------------
    def subgraph(self, names: Iterable[str]) -> "Graph":
        keep = set(names)
        g = Graph(f"{self.name}.sub")
        for n in self.topo_order():
            if n in keep:
                node = self._nodes[n]
                g.add(node.with_deps([d for d in node.deps if d in keep]))
        return g

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Graph({self.name!r}, n={len(self)}, width={self.width()}, "
            f"flops={self.total_flops():.3g})"
        )
