"""Discrete-event simulator of the Graphi execution engine.

Replays the paper's runtime (centralized scheduler + N symmetric executors,
per-executor buffers vs a naive shared global queue) under a
:class:`~repro_torch.core.cost_model.HardwareModel`.  This is the *measurement
instrument* for every paper-table reproduction on this CPU-only box: the
scheduling semantics are exact (online greedy list scheduling, dependency
triggering, dispatch serialization); the op durations come from the cost
model (optionally jittered to model run-time variation, paper §4.3).

Policies
--------
``SimConfig.policy`` is either a *registry* policy — a name (or instance)
resolved through :mod:`repro_torch.core.policies`: ``cpf``, ``level-pack``,
``lpt``, ``cpf-perturb``, plus anything user-registered — or one of the two
naive shared-queue baselines the paper compares against:

* registry policies run the Graphi dispatch path: centralized scheduler
  orders ready ops by the policy's priority (stable node-id tiebreak) and
  pushes to per-executor buffers; dispatch costs ``cpf_push_cost``
  (serialized at the scheduler core, cheap — bitmap scan + ring-buffer
  push).  A policy's optional executor-assignment hook steers ops among
  the executors free earliest.
* ``fifo``   — naive shared queue in trigger order (TensorFlow/MXNet style).
  Each dequeue serializes on the queue lock and costs
  ``queue_base_cost + queue_contention_cost × (#free executors polling)``.
* ``random`` — naive shared queue, arbitrary ready op (MXNet-style "any
  executor grabs any ready op").

Determinism: ready ops with equal priority pop in stable **node-id order**
(graph insertion index), never in dict/hash order, so two simulations of
one graph produce identical traces — the schedule-search winner is
reproducible run to run (tests/test_policies_search.py).
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field

from .cost_model import HardwareModel, graph_costs
from .graph import Graph
from .policies import NAIVE_POLICIES, PolicyContext, SchedulePolicy, get_policy

__all__ = ["SimConfig", "SimResult", "TraceEvent", "simulate"]


@dataclass(frozen=True)
class TraceEvent:
    op: str
    executor: int
    start: float
    end: float


@dataclass(frozen=True)
class SimConfig:
    n_executors: int
    team_size: int
    # a repro_torch.core.policies registry name/instance, or "fifo"/"random"
    policy: "str | SchedulePolicy" = "cpf"
    # dispatch-path costs (seconds).  The shared-queue costs are calibrated
    # to KNL lock handoff under contention (cache-line ping-pong across the
    # 2D mesh at 1.4 GHz is ~us-scale per waiter; the paper's Table-2
    # 8-19% gap is the macro observable this reproduces).
    cpf_push_cost: float = 0.3e-6
    queue_base_cost: float = 1.0e-6
    queue_contention_cost: float = 1.5e-6
    # interference (paper Fig 3 / §3.1).  ``duration_multiplier`` is the
    # legacy scalar guess: multiplies every op duration uniformly.
    # ``contention`` is the measured replacement — an object with
    # ``multiplier_for(node, co_resident_nodes) -> float``
    # (repro.hwperf.model.ContentionModel): each op's duration is scaled by
    # the worst measured pairwise slowdown against the ops co-resident at
    # its dispatch.  Both compose (scalar first) for A/B comparisons.
    duration_multiplier: float = 1.0
    contention: object | None = None
    # run-time variation (paper §4.3, "unpredictable variations")
    jitter: float = 0.0
    # TP collective term applies when an op is sharded over a linked fabric
    tp_collective: bool = True
    # paper §6 "data cache locality": prefer the executor that produced an
    # op's input; matched elementwise ops run faster (L2-resident input),
    # GEMMs don't (MKL blocking defeats affinity — the paper's finding)
    cache_affinity: bool = False
    affinity_speedup: dict | None = None   # kind -> fractional speedup


@dataclass
class SimResult:
    makespan: float
    trace: list[TraceEvent]
    config: SimConfig
    op_costs: dict[str, float] = field(repr=False, default_factory=dict)

    @property
    def busy_time(self) -> float:
        return sum(e.end - e.start for e in self.trace)

    @property
    def utilization(self) -> float:
        denom = self.makespan * self.config.n_executors
        return self.busy_time / denom if denom else 0.0

    def executor_timeline(self) -> dict[int, list[TraceEvent]]:
        out: dict[int, list[TraceEvent]] = {e: [] for e in range(self.config.n_executors)}
        for ev in self.trace:
            out[ev.executor].append(ev)
        for evs in out.values():
            evs.sort(key=lambda e: e.start)
        return out

    def start_order(self) -> list[str]:
        return [e.op for e in sorted(self.trace, key=lambda e: (e.start, e.op))]


def simulate(
    graph: Graph,
    hw: HardwareModel,
    cfg: SimConfig,
    *,
    costs: dict[str, float] | None = None,
    seed: int = 0,
) -> SimResult:
    """Run the event-driven engine simulation and return the makespan+trace."""
    naive = isinstance(cfg.policy, str) and cfg.policy in NAIVE_POLICIES
    policy: SchedulePolicy | None = None if naive else get_policy(cfg.policy)
    rng = random.Random(seed)

    if costs is None:
        costs = graph_costs(hw, graph, cfg.team_size, tp_collective=cfg.tp_collective)
    levels = graph.levels(costs)

    indeg = {n: graph.in_degree(n) for n in graph.names}
    ready_time: dict[str, float] = {}
    # stable node-id order (graph insertion index): THE tiebreak for
    # equal-priority ready ops, and the only ordering policies' priority
    # dicts are ever combined with — never dict/hash order.  This is what
    # makes search scores (and the chosen winner) reproducible run-to-run.
    seq = {n: i for i, n in enumerate(graph.names)}

    if policy is not None:
        ctx = PolicyContext(
            graph=graph, costs=costs, levels=levels,
            depths=graph.depth_levels(), n_executors=cfg.n_executors,
            seed=seed,
        )
        prio = policy.priorities(ctx)

    # ready-op container: priority heap for registry policies, trigger-order
    # list for the naive shared-queue baselines
    ready_heap: list[tuple[float, int, str]] = []     # (-priority, node_id, name)
    fifo_list: list[str] = []

    def push_ready(n: str, t: float) -> None:
        ready_time[n] = t
        if policy is not None:
            heapq.heappush(ready_heap, (-prio[n], seq[n], n))
        else:
            fifo_list.append(n)

    def pop_ready() -> str:
        if policy is not None:
            return heapq.heappop(ready_heap)[-1]
        if cfg.policy == "fifo":
            return fifo_list.pop(0)
        i = rng.randrange(len(fifo_list))
        return fifo_list.pop(i)

    def have_ready() -> bool:
        return bool(ready_heap) if policy is not None else bool(fifo_list)

    for n in graph.names:
        if indeg[n] == 0:
            push_ready(n, 0.0)

    exec_free: list[tuple[float, int]] = [(0.0, e) for e in range(cfg.n_executors)]
    heapq.heapify(exec_free)
    completions: list[tuple[float, int, str, int]] = []  # (end, seq, op, executor)
    dispatch_free = 0.0  # serialization point (queue lock / scheduler core)
    trace: list[TraceEvent] = []
    n_done = 0
    total = len(graph)
    producer_exec: dict[str, int] = {}   # op -> executor that ran it (§6)
    affinity = cfg.affinity_speedup or {"elementwise": 0.08}

    def process_completion() -> None:
        nonlocal n_done
        end, _, op, e = heapq.heappop(completions)
        n_done += 1
        producer_exec[op] = e
        heapq.heappush(exec_free, (end, e))
        for s in graph.successors(op):
            indeg[s] -= 1
            if indeg[s] == 0:
                push_ready(s, end)

    while n_done < total:
        if have_ready() and exec_free:
            ft, e = exec_free[0]
            if completions and completions[0][0] < ft:
                # an earlier completion may ready a higher-priority op
                process_completion()
                continue
            heapq.heappop(exec_free)
            op = pop_ready()
            want: int | None = None
            if policy is not None:
                # the policy's assignment hook picks among executors free no
                # later than the earliest one — a placement choice only,
                # never a delay
                free_now = tuple(sorted(
                    [e] + [e2 for ft2, e2 in exec_free if ft2 <= ft]))
                want = policy.assign_executor(ctx, op, free_now)
            if want is None and cfg.cache_affinity:
                # prefer the producer of op's (first) input when it is also
                # free at the same time (the paper's "preferred executor")
                prefs = {producer_exec.get(d) for d in graph.predecessors(op)}
                if e not in prefs:
                    want = next((e2 for ft2, e2 in exec_free
                                 if ft2 <= ft and e2 in prefs), None)
            if want is not None and want != e:
                for i, (ft2, e2) in enumerate(exec_free):
                    if e2 == want and ft2 <= ft:
                        exec_free[i] = (ft, e)
                        heapq.heapify(exec_free)
                        e = want
                        break
            t0 = max(ft, ready_time[op])
            # dispatch serialization.  Naive shared queue: every executor
            # polls the one lock continuously (paper §3.1 "heavy concurrent
            # use"), so each dequeue pays handoff x #executors — not just
            # the currently-idle ones.
            if policy is not None:
                deq = cfg.cpf_push_cost
            else:
                deq = cfg.queue_base_cost + cfg.queue_contention_cost * cfg.n_executors
            start = max(t0, dispatch_free) + deq
            dispatch_free = start
            dur = costs[op] * cfg.duration_multiplier
            if cfg.contention is not None:
                # measured interference: ops still in flight at this op's
                # start are its co-residents; scale by the worst pairwise
                # class slowdown the co-location harness measured
                co = [graph[o] for (c_end, _, o, _) in completions
                      if c_end > start]
                dur *= cfg.contention.multiplier_for(graph[op], co)
            if cfg.cache_affinity and any(
                producer_exec.get(d) == e for d in graph.predecessors(op)
            ):
                dur *= 1.0 - affinity.get(graph[op].kind, 0.0)
            if cfg.jitter:
                dur *= max(0.05, 1.0 + cfg.jitter * rng.gauss(0.0, 1.0))
            end = start + dur
            heapq.heappush(completions, (end, seq[op], op, e))
            trace.append(TraceEvent(op, e, start, end))
        else:
            process_completion()

    makespan = max((e.end for e in trace), default=0.0)
    return SimResult(makespan=makespan, trace=trace, config=cfg, op_costs=dict(costs))
