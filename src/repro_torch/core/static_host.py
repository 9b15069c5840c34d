"""Compiled static host plans: the scheduler off the per-op hot path.

The dynamic :class:`~repro_torch.core.engine.HostScheduler` is paper-faithful
(§5.2): a centralized scheduler thread makes a placement decision per op and
pays a triggered-queue round-trip per completion.  For a graph executed once
that overhead is noise; for a serving decode loop that replays the *same*
small graph once per token it **is** the latency floor — exactly the
contention the paper says kills small-op parallelism.

A :class:`StaticHostPlan` freezes the CPF schedule we already computed
(Mayer et al.: the critical path decided the placement; nothing about it
changes between runs) into per-executor **op programs over integer node
ids**:

* flat result buffers (``results[id]``) instead of name-keyed dicts,
* precomputed argument-index tuples (``arg_ids[id]``),
* precomputed successor id lists (``succ_ids[id]``),
* lock-free dependency counters — one :class:`itertools.count` per fan-in
  node (``count.__next__`` is a single C call, atomic under the GIL): every
  producer bumps its consumers' counters, and exactly one producer observes
  the final value and *directly runs* the op it unblocked (same executor)
  or enqueues it on the owning executor's per-run ready queue.

There is **no central dispatch loop** at run time: no triggered-queue drain,
no ``heapq``, no least-loaded-executor scan.  The client thread resolves
input passthroughs inline, seeds the zero-dependency ops, submits one
*segment* per executor to an :class:`~repro_torch.core.engine.ExecutorPool` (so
static runs interleave with dynamic runs on the same persistent executors),
and waits for the segments to finish — one reply-queue hop per executor per
*run* instead of two hops per *op*.

On CUDA executors each segment launches on its executor's stream.  A
segment first waits on an event after the caller's queued work (the
inputs); an op with a consumer on another executor records an event after
its launch, and that consumer's stream waits on it before launching.  The
caller's stream waits for every executor stream of the run before the
results are handed back (``record_stream`` on the caller's stream).

Failure protocol: the first op exception is recorded on the run state and a
poison id is pushed to every ready queue; segments exit on poison, and the
client raises the same ``RuntimeError("op ... failed on executor ...")`` the
dynamic runtime raises.
"""
from __future__ import annotations

import itertools
import queue
import sys
import time
from dataclasses import dataclass
from functools import partial
from threading import Lock
from typing import Any, Callable, Mapping

import torch

from .engine import (_ERR, DeadlineExceeded, ExecutorPool, HostRunResult, entry_event,
                     join_streams, record_on)
from .graph import Graph, GraphValidationError
from .scheduler import Schedule
from .simulate import TraceEvent

__all__ = ["StaticHostPlan", "compile_host_plan", "layered_graph"]

_POISON = -1


def layered_graph(L: int = 6, W: int = 3, *, flops: float = 10.0) -> Graph:
    """Decode-shaped reference DAG: ``W`` parallel ~free ops per layer
    feeding a join, ``L`` layers deep, one inline-resolved input.

    The shape the static-plan machinery exists for — a small graph replayed
    many times where scheduling overhead dominates.  Shared by the
    scheduler-overhead bench (`scripts/bench_sched_overhead.py`) and the
    static-plan tests so they exercise the identical structure.
    """
    g = Graph("layered")
    g.add_op("x", kind="input")
    prev = "x"
    for layer in range(L):
        for w in range(W):
            g.add_op(f"l{layer}w{w}", deps=(prev,), flops=flops,
                     fn=lambda v, w=w: v + w)
        g.add_op(f"j{layer}", deps=tuple(f"l{layer}w{w}" for w in range(W)),
                 flops=flops, fn=lambda *xs: sum(xs))
        prev = f"j{layer}"
    g.add_op("out", deps=(prev,), flops=1.0, fn=lambda v: v * 2)
    return g


def compile_host_plan(
    graph: Graph, schedule: Schedule, n_executors: int | None = None
) -> StaticHostPlan:
    """Freeze ``schedule``'s placements into a :class:`StaticHostPlan`.

    ``n_executors`` defaults to the schedule's executor count; a smaller
    count folds placements onto the available executors (``e % n``) — the
    pool a plan runs on may be narrower than the profiled config.  Input
    passthroughs (``fn is None``) are compiled *out* of the programs: the
    client thread resolves them inline at run start.
    """
    n_exec = schedule.n_executors if n_executors is None else n_executors
    if n_exec < 1:
        raise ValueError(f"need >= 1 executor, got {n_exec}")
    names = tuple(graph.names)
    ids = {n: i for i, n in enumerate(names)}
    nodes = [graph[n] for n in names]
    is_input = [nd.fn is None for nd in nodes]
    for nd, inp in zip(nodes, is_input):
        if inp and nd.deps:
            raise GraphValidationError(
                f"node {nd.name!r} has deps but no fn — static plans resolve "
                "fn-less nodes inline from inputs, which requires them to be "
                "sources"
            )
    input_ids = tuple(i for i in range(len(names)) if is_input[i])
    arg_ids = tuple(tuple(ids[d] for d in nd.deps) for nd in nodes)
    # consumers to notify on completion; input nodes notify nobody (their
    # consumers never wait on them — see n_wait) and are never notified
    succ_ids = tuple(
        () if is_input[i] else tuple(ids[s] for s in graph.successors(n))
        for i, n in enumerate(names)
    )
    # counter target: deps that are *executed* (inputs are pre-resolved)
    n_wait = tuple(
        sum(1 for d in nd.deps if not is_input[ids[d]]) for nd in nodes
    )

    owner = [-1] * len(names)
    programs: list[list[int]] = [[] for _ in range(n_exec)]
    for e, ops in enumerate(schedule.by_executor(n_exec)):
        for nm in ops:
            i = ids.get(nm)
            if i is None:
                raise GraphValidationError(
                    f"schedule places unknown op {nm!r} (graph {graph.name!r})"
                )
            if is_input[i]:
                continue
            owner[i] = e
            programs[e].append(i)
    missing = [names[i] for i in range(len(names))
               if not is_input[i] and owner[i] < 0]
    if missing:
        raise GraphValidationError(
            f"schedule does not place ops {missing[:4]!r} of graph {graph.name!r}"
        )
    seeds = tuple(
        tuple(i for i in prog if n_wait[i] == 0) for prog in programs
    )
    # ops whose result another executor consumes: on CUDA executors they
    # record an event for that consumer's stream to wait on
    cross = tuple(
        any(owner[s] != owner[i] for s in succ_ids[i]) for i in range(len(names))
    )
    return StaticHostPlan(
        graph=graph,
        graph_version=graph.version,
        n_executors=n_exec,
        names=names,
        ids=ids,
        fns=tuple(nd.fn for nd in nodes),
        arg_ids=arg_ids,
        succ_ids=succ_ids,
        n_wait=n_wait,
        owner=tuple(owner),
        programs=tuple(tuple(p) for p in programs),
        input_ids=input_ids,
        seeds=seeds,
        cross=cross,
        policy=schedule.policy,
        seed=schedule.seed,
    )


@dataclass(frozen=True)
class StaticHostPlan:
    """A graph + frozen CPF placements compiled to integer-id executor
    programs.  Immutable; per-run state lives in :class:`_PlanRun`."""

    graph: Graph
    graph_version: int                        # Graph.version at compile time
    n_executors: int
    names: tuple[str, ...]                    # id -> name (insertion order)
    ids: Mapping[str, int]                    # name -> id
    fns: tuple[Callable[..., Any] | None, ...]
    arg_ids: tuple[tuple[int, ...], ...]      # id -> dep ids (arg order)
    succ_ids: tuple[tuple[int, ...], ...]     # id -> consumer ids
    n_wait: tuple[int, ...]                   # id -> executed-dep count
    owner: tuple[int, ...]                    # id -> executor (-1: input)
    programs: tuple[tuple[int, ...], ...]     # executor -> owned ids
    input_ids: tuple[int, ...]                # resolved inline from inputs
    seeds: tuple[tuple[int, ...], ...]        # executor -> ready-at-start ids
    cross: tuple[bool, ...] = ()              # id -> consumed on another executor
    # provenance: the scheduling policy (+ its seed) whose placements this
    # plan froze — "cpf", or a searched winner such as "cpf-perturb"
    policy: str = "cpf"
    seed: int = 0

    @property
    def n_ops(self) -> int:
        """Executed ops per run (inputs excluded)."""
        return sum(len(p) for p in self.programs)

    def describe(self) -> str:
        widths = ",".join(str(len(p)) for p in self.programs)
        pol = self.policy if self.seed == 0 else f"{self.policy}@{self.seed}"
        return (
            f"StaticHostPlan({self.graph.name!r}, {self.n_executors} executors, "
            f"{self.n_ops} ops [{widths}], {len(self.input_ids)} inputs, "
            f"policy={pol})"
        )

    # -- execution ----------------------------------------------------------
    def run(
        self,
        inputs: Mapping[str, Any] | None = None,
        pool: ExecutorPool | None = None,
        *,
        collect_trace: bool = False,
        deadline: float | None = None,
    ) -> HostRunResult:
        """Execute the plan; returns the same :class:`HostRunResult` shape as
        the dynamic runtime (``trace`` is empty unless ``collect_trace`` —
        per-op timestamps are exactly the overhead this path removes).

        Without a ``pool`` an ephemeral one is spun up for the run; with one,
        segments are queued atomically behind whatever the pool is already
        running (dynamic ops or another plan's segments).

        ``deadline`` (absolute, ``time.monotonic``) bounds the wait for
        segment completion: on expiry every ready queue is poisoned — idle
        segments exit — and :class:`~repro_torch.core.engine.DeadlineExceeded`
        is raised naming whatever ops are still on executor threads, so a
        hung op frees this run's lease instead of wedging it forever.
        """
        inputs = inputs or {}
        if self.graph.version != self.graph_version:
            # same staleness guard as HostScheduler.run: the frozen integer
            # programs would silently skip any node added since compile
            raise GraphValidationError(
                f"graph {self.graph.name!r} mutated (version "
                f"{self.graph_version} -> {self.graph.version}) after this "
                "plan was compiled — recompile the plan"
            )
        if pool is not None and pool.n_executors < self.n_executors:
            raise ValueError(
                f"plan needs {self.n_executors} executors but pool has "
                f"{pool.n_executors} — recompile the plan for the pool size"
            )
        ephemeral = pool is None
        if ephemeral:
            pool = ExecutorPool(self.n_executors)
        state = _PlanRun(self)
        streams = getattr(pool, "streams", None)
        if streams is not None:
            state.entry = entry_event(pool.device)
        results = state.results
        names = self.names
        for i in self.input_ids:
            nm = names[i]
            if nm not in inputs:
                raise GraphValidationError(f"node {nm!r} has no fn and no input")
            results[i] = inputs[nm]
        for e, seed in enumerate(self.seeds):
            q = state.ready[e]
            for i in seed:
                q.put(i)
        reply: queue.SimpleQueue = queue.SimpleQueue()
        t_origin = time.perf_counter()
        active = [e for e in range(self.n_executors) if self.programs[e]]
        try:
            pool.submit_segments(
                [
                    (
                        e,
                        f"{self.graph.name}#seg{e}",
                        partial(_run_segment, self, state, e, t_origin,
                                collect_trace),
                    )
                    for e in active
                ],
                reply,
                t_origin,
            )
            seg_err: tuple[Any, int] | None = None
            for _ in active:
                if deadline is None:
                    msg = reply.get()
                else:
                    try:
                        msg = reply.get(
                            timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        # poison first: segments blocked on their ready
                        # queue exit immediately and give their executor
                        # back; only the executor actually inside the hung
                        # op stays busy (the caller quarantines it)
                        for q in state.ready:
                            q.put(_POISON)
                        busy = ""
                        if hasattr(pool, "current_tasks"):
                            cur = [c[0] for c in pool.current_tasks() if c]
                            busy = f"; executors busy in {cur!r}" if cur else ""
                        raise DeadlineExceeded(
                            f"plan {self.graph.name!r}: deadline exceeded "
                            f"with segments unfinished{busy}") from None
                if msg[0] is _ERR and seg_err is None:  # pragma: no cover
                    # segment infrastructure died outside the per-op try:
                    # poison the siblings (they may be blocked waiting for
                    # ops the dead segment never ran) and keep draining, so
                    # a shared pool's executors are not wedged forever
                    seg_err = (msg[1], msg[2])
                    for q in state.ready:
                        q.put(_POISON)
        finally:
            if ephemeral:
                pool.close(raise_on_stuck=sys.exc_info()[0] is None)
        if seg_err is not None:  # pragma: no cover — segment infra only
            raise RuntimeError(
                f"plan segment died on executor {seg_err[1]}") from seg_err[0]
        if state.error is not None:
            nm, e = state.error_at
            raise RuntimeError(f"op {nm!r} failed on executor {e}") from state.error
        if streams is not None:
            join_streams(pool.device, [streams[e] for e in active], results)
        wall = time.perf_counter() - t_origin
        trace = sorted(state.trace, key=lambda ev: ev.start)
        # untraced runs fall back to per-segment end stamps: last op end,
        # like the dynamic runtime's makespan, not client-observed wall
        makespan = max((ev.end for ev in trace), default=0.0) or \
            max((t for t in state.seg_end if t > 0.0), default=wall)
        return HostRunResult(
            outputs=dict(zip(names, results)),
            trace=trace,
            makespan=makespan,
            peak_inflight=1,
        )


class _PlanRun:
    """Mutable per-run state: flat result buffer, dependency counters, and
    per-executor ready queues.  One instance per ``StaticHostPlan.run``."""

    __slots__ = ("results", "pending", "ready", "trace", "seg_end", "error",
                 "error_at", "_lock", "entry", "events")

    def __init__(self, plan: StaticHostPlan):
        self.results: list[Any] = [None] * len(plan.names)
        # a counter only where there is a race to lose: fan-in >= 2
        self.pending = [
            itertools.count() if w >= 2 else None for w in plan.n_wait
        ]
        self.ready = [queue.SimpleQueue() for _ in range(plan.n_executors)]
        self.trace: list[TraceEvent] = []
        self.seg_end: list[float] = [0.0] * plan.n_executors
        self.error: BaseException | None = None
        self.error_at: tuple[str, int] = ("", -1)
        self._lock = Lock()
        # CUDA executors: the caller's entry event and, per cross-executor
        # producer, the event after its launch
        self.entry: Any = None
        self.events: list[Any] = [None] * len(plan.names)

    def fail(self, exc: BaseException, name: str, executor: int) -> None:
        with self._lock:
            if self.error is None:
                self.error = exc
                self.error_at = (name, executor)
        for q in self.ready:
            q.put(_POISON)


def _run_segment(
    plan: StaticHostPlan,
    state: _PlanRun,
    e: int,
    t_origin: float,
    collect_trace: bool,
) -> int:
    """Executor ``e``'s share of one plan run.

    Runs as a single pool work item: drains a local stack first (ops this
    executor just unblocked for itself — zero queue hops), then blocks on
    its per-run ready queue.  Exits after completing exactly its program
    length, or on a poison id after another segment failed.
    """
    fns = plan.fns
    arg_ids = plan.arg_ids
    succ_ids = plan.succ_ids
    owner = plan.owner
    need = plan.n_wait
    results = state.results
    pending = state.pending
    ready = state.ready
    get = ready[e].get
    local: list[int] = []
    pop = local.pop
    push = local.append
    remaining = len(plan.programs[e])
    t0 = 0.0
    cuda = state.entry is not None
    if cuda:
        stream = torch.cuda.current_stream()
        stream.wait_event(state.entry)
        events = state.events
        cross = plan.cross
    while remaining:
        if local:
            i = pop()
        else:
            i = get()
            if i < 0:
                return remaining
        try:
            if collect_trace:
                t0 = time.perf_counter() - t_origin
            args = [results[d] for d in arg_ids[i]]
            if cuda:
                for d in arg_ids[i]:
                    if owner[d] >= 0 and owner[d] != e:
                        stream.wait_event(events[d])
                record_on(args, stream)
            results[i] = fns[i](*args)
            if cuda and cross[i]:
                ev = events[i] = torch.cuda.Event()
                ev.record(stream)
        except BaseException as exc:  # noqa: BLE001 — relayed to the client
            state.fail(exc, plan.names[i], e)
            return remaining
        if collect_trace:
            state.trace.append(
                TraceEvent(plan.names[i], e, t0, time.perf_counter() - t_origin)
            )
        remaining -= 1
        for s in succ_ids[i]:
            w = need[s]
            if w == 1 or next(pending[s]) == w - 1:
                o = owner[s]
                if o == e:
                    push(s)
                else:
                    ready[o].put(s)
    state.seg_end[e] = time.perf_counter() - t_origin
    return 0
