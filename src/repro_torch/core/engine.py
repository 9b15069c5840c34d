"""Host runtime: executor pool + the paper-faithful dynamic scheduler.

* :class:`HostScheduler` — the **paper-faithful dynamic runtime**: a
  centralized scheduler (runs on the client thread, §5.2) with critical-path-
  first priority, per-executor operation buffers (depth ``buffer_depth``),
  executor worker threads, and a triggered-operation return queue.  Validated
  against the sequential interpreter.

* :class:`ExecutorPool` — a **persistent** set of executor threads that
  outlives any single run.  Several :class:`HostScheduler` runs — several
  *graphs* — submit to one pool concurrently (each run drains its own
  triggered queue), which is what lets a serve engine overlap a prefill
  graph with the in-flight decode graph on the same executors.  A process
  normally has exactly one, owned by :class:`repro_torch.runtime.Runtime`, which
  leases disjoint executor subsets to concurrent runs.

On a CUDA device an executor is a host thread that launches its ops on its
own ``torch.cuda.Stream`` (what the paper's executor becomes on a GPU: the
SMs are shared by every stream, the host thread feeds one queue of
kernels).  A cross-executor dependency is a CUDA event: the producer records
one on its stream after its launch, the consumer's stream waits on it before
its own launch, and every tensor consumed on a stream other than the one
that made it is ``record_stream``-ed there so the caching allocator cannot
hand its memory out early.  Inputs from the caller are ordered behind an
event on the caller's stream, and the caller's stream waits for every
executor stream of the run before the results are handed back.  On the CPU
executors are plain threads, as in the JAX package.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import queue
import sys
import threading
import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Mapping, Sequence

import torch

from .graph import Graph
from .simulate import TraceEvent

__all__ = ["DeadlineExceeded", "ExecutorPool", "HostScheduler", "HostRunResult"]

_ERR = object()   # triggered-queue sentinel: an executor relayed an exception


# -- CUDA stream handoff -------------------------------------------------------

def record_on(value: Any, stream: "torch.cuda.Stream") -> None:
    """``record_stream`` every CUDA tensor in ``value`` (a tensor or nested
    tuples/lists) on ``stream``: the allocator then keeps its memory until
    ``stream``'s work queued so far has finished."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            value.record_stream(stream)
    elif isinstance(value, (tuple, list)):
        for v in value:
            record_on(v, stream)


def stream_call(fn: Callable[..., Any], args: tuple, waits: Sequence[Any]) -> tuple:
    """Run one node ``fn`` on the calling executor thread's stream after the
    events its inputs were produced under; returns ``(out, done_event)``."""
    stream = torch.cuda.current_stream()
    for ev in waits:
        stream.wait_event(ev)
    record_on(args, stream)
    out = fn(*args)
    done = torch.cuda.Event()
    done.record(stream)
    return out, done


def entry_event(device: torch.device) -> "torch.cuda.Event":
    """An event after everything the caller has queued on its stream (the
    inputs of a run are made there)."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def join_streams(device: torch.device, streams: Sequence[Any], outputs: Any) -> None:
    """Order the caller's stream after all work queued on ``streams`` and
    hand it the results (``record_stream`` on the caller's stream)."""
    caller = torch.cuda.current_stream(device)
    for s in streams:
        ev = torch.cuda.Event()
        ev.record(s)
        caller.wait_event(ev)
    for v in outputs:
        record_on(v, caller)

_log = logging.getLogger(__name__)


class DeadlineExceeded(TimeoutError):
    """A host run overshot its deadline with ops still in flight.

    The run abandons its results and frees its executor lease; the op(s)
    that wedged keep their executor threads busy until they return (Python
    threads cannot be killed), which is why callers holding a lease
    quarantine the still-busy executors instead of handing them to the next
    run (``repro_torch.runtime._Admission.quarantine``)."""


class ExecutorPool:
    """Persistent executor threads shared across HostScheduler runs.

    Each executor owns its buffer queue (the paper's per-executor operation
    buffer — no shared global queue).  A work item carries the submitting
    run's reply queue, so *multiple graphs* can be in flight on one pool at
    once: a serve engine submits its prefill Executable and its decode
    Executable concurrently and each run drains only its own completions.

    Exceptions raised by an op are relayed to the submitting run's reply
    queue and the executor thread keeps serving — a failed graph must not
    take the pool down for the other graphs using it.

    ``device``: a CUDA device gives every executor its own stream
    (:attr:`streams`), current on that executor's thread for its lifetime;
    ``None`` or a CPU device keeps plain threads (``streams`` is ``None``).
    """

    def __init__(self, n_executors: int, *, device: str | torch.device | None = None):
        if n_executors < 1:
            raise ValueError(f"need >= 1 executor, got {n_executors}")
        self.n_executors = n_executors
        self.device = torch.device(device) if device is not None else None
        self.streams: list | None = None
        if self.device is not None and self.device.type == "cuda":
            self.streams = [torch.cuda.Stream(device=self.device) for _ in range(n_executors)]
        # SimpleQueue: C-level put/get, ~3x cheaper per hop than Queue —
        # the decode loop pays one round-trip per chained node per step
        self._buffers: list[queue.SimpleQueue] = [queue.SimpleQueue() for _ in range(n_executors)]
        self._segment_lock = threading.Lock()
        self._seg_batches = itertools.count()
        # (executor, batch_no, segment_name) per segment enqueue, in buffer
        # order, when enabled: the evidence `repro_torch.checks` replays to verify
        # batches land FIFO-consistently (no cross-plan deadlock) instead of
        # assuming the lock above works
        self.segment_log: list[tuple[int, int, str]] | None = None
        # per-executor (task name, started_at monotonic) while an op runs,
        # None when idle: the liveness signal deadline aborts and the stuck-
        # close diagnostic read to name *which* op wedged *which* executor
        self._current: list[tuple[str, float] | None] = [None] * n_executors
        # executors whose threads outlived close(): a nonempty tuple marks
        # the pool unhealthy — its threads are stuck inside an op
        self.stuck_executors: tuple[tuple[int, str], ...] = ()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, args=(e,), daemon=True,
                             name=f"graphi-executor-{e}")
            for e in range(n_executors)
        ]
        for t in self._threads:
            t.start()

    def submit(
        self,
        ex: int,
        name: str,
        task: Callable[[], Any],
        reply: queue.SimpleQueue,
        t_origin: float,
    ) -> None:
        if self._closed:
            raise RuntimeError("ExecutorPool is closed")
        self._buffers[ex].put((name, task, reply, t_origin))

    def submit_segments(
        self,
        items: list[tuple[int, str, Callable[[], Any]]],
        reply: queue.SimpleQueue,
        t_origin: float,
    ) -> None:
        """Queue one static-plan segment per executor, atomically.

        Segments (``repro_torch.core.static_host``) block-wait for their peers, so
        two plans whose segment batches interleaved in opposite orders on two
        buffers would deadlock — the lock makes every batch land in the same
        relative order on every buffer.  Dynamic ops may interleave freely:
        they never wait inside an executor thread.
        """
        if self._closed:
            raise RuntimeError("ExecutorPool is closed")
        with self._segment_lock:
            batch = next(self._seg_batches)
            for ex, name, task in items:
                if self.segment_log is not None:
                    self.segment_log.append((ex, batch, name))
                self._buffers[ex].put((name, task, reply, t_origin))

    def qsize(self, ex: int) -> int:
        """Approximate queued depth on one executor (cross-run load signal)."""
        return self._buffers[ex].qsize()

    def executor_thread_ids(self) -> list[int | None]:
        """OS-level (native) thread id per executor, ``None`` for a thread
        not yet started or already exited (the handles core pinning would
        pass to ``os.sched_setaffinity``)."""
        return [t.native_id if t.is_alive() else None for t in self._threads]

    def current_tasks(self) -> list[tuple[str, float] | None]:
        """Snapshot of what each executor is running *right now*:
        ``(op name, started_at)`` per executor, ``None`` when idle.  The
        liveness probe behind deadline aborts, executor quarantine, and the
        stuck-close diagnostic."""
        return list(self._current)

    def close(self, timeout: float = 5.0, *, raise_on_stuck: bool = True) -> None:
        """Shut the executor threads down. Idempotent and segment-safe:

        * the shutdown sentinels go in under the segment lock, so they can
          never split an in-flight ``submit_segments`` batch — work queued
          *before* close (including a whole static plan) still completes
          (SimpleQueue is FIFO: every item precedes its buffer's sentinel);
        * a second ``close()`` — or one racing the first from another
          thread — neither re-poisons the buffers nor raises; it just joins
          whatever threads remain;
        * closing from an executor thread itself (an op that tears its own
          pool down) skips the self-join instead of raising.

        A thread that outlives its ``timeout``-second join is **stuck inside
        an op**: the pool records it in :attr:`stuck_executors` (with the
        op's name), logs the diagnostic, and raises ``RuntimeError`` —
        returning silently would let the caller believe every executor
        exited when one is still holding a thread (and whatever memory its
        task closed over).  ``raise_on_stuck=False`` keeps the record and
        the log but suppresses the raise, for close calls already on an
        exception path that must not be masked.
        """
        with self._segment_lock:
            if not self._closed:
                self._closed = True
                for b in self._buffers:
                    b.put(None)
        me = threading.current_thread()
        deadline = time.monotonic() + timeout
        stuck: list[tuple[int, str]] = []
        for e, t in enumerate(self._threads):
            if t is me:
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                cur = self._current[e]
                stuck.append((e, cur[0] if cur else "<between ops>"))
        if stuck:
            self.stuck_executors = tuple(stuck)
            detail = ", ".join(f"executor {e} in op {nm!r}" for e, nm in stuck)
            _log.warning(
                "ExecutorPool.close: %d executor thread(s) still running "
                "after %.1fs — %s; pool is unhealthy", len(stuck), timeout,
                detail)
            if raise_on_stuck:
                raise RuntimeError(
                    f"ExecutorPool.close: {len(stuck)} executor thread(s) "
                    f"stuck after {timeout:.1f}s ({detail})")

    def __enter__(self) -> "ExecutorPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _worker(self, ex: int) -> None:
        if self.streams is not None:
            # thread-local: every op this executor runs launches here
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.streams[ex])
        while True:
            item = self._buffers[ex].get()
            if item is None:
                return
            name, task, reply, t_origin = item
            self._current[ex] = (name, time.monotonic())
            t0 = time.perf_counter() - t_origin
            try:
                out = task()
            except BaseException as e:  # noqa: BLE001 — relayed to the run
                self._current[ex] = None
                reply.put((_ERR, e, ex, name, 0.0))
                del item, task
                continue
            t1 = time.perf_counter() - t_origin
            self._current[ex] = None
            reply.put((name, out, ex, t0, t1))
            # an idle executor must not pin its last task (a static-plan
            # segment closes over the whole plan -> graph) or result arrays
            # until the next item arrives
            del item, task, out


def _input_lookup(inputs: Mapping[str, Any], name: str) -> Any:
    return inputs[name]


@dataclass
class HostRunResult:
    outputs: dict[str, Any]
    trace: list[TraceEvent]
    makespan: float
    peak_inflight: int = 1      # max ops queued on one executor (buffer use)


class HostScheduler:
    """Centralized scheduler + N executor threads with per-executor buffers.

    Executors poll *their own* buffer (no shared global queue — the paper's
    contention fix); on completion they push (op, result) onto the triggered
    queue, which the scheduler drains (Algorithm 1/2).  Each executor buffer
    holds up to ``buffer_depth`` dispatched ops, so an executor finishing one
    op can start the next without a scheduler round-trip.

    ``pool`` binds the run to a shared persistent :class:`ExecutorPool`
    (``n_executors`` then follows the pool's size); without one, each
    ``run()`` spins up an ephemeral pool and tears it down on exit — or
    takes a per-run pool/lease via ``run(pool=...)``, which is how a
    :class:`repro_torch.runtime.Runtime` executes the same scheduler on a fresh
    :class:`~repro_torch.runtime.ExecutorLease` every run without rebuilding the
    hoisted per-graph immutables.
    """

    def __init__(
        self,
        graph: Graph,
        n_executors: int,
        *,
        costs: Mapping[str, float] | None = None,
        buffer_depth: int = 1,
        pool: ExecutorPool | None = None,
    ):
        if n_executors < 1:
            raise ValueError(f"need >= 1 executor, got {n_executors}")
        if buffer_depth < 1:
            raise ValueError(f"need buffer_depth >= 1, got {buffer_depth}")
        self.graph = graph
        self.pool = pool
        self.n_executors = pool.n_executors if pool is not None else n_executors
        costs = costs or {n: max(g.flops, 1.0) for n, g in zip(graph.names, graph.nodes)}
        self.levels = graph.levels({n: float(costs[n]) for n in graph.names})
        self.buffer_depth = buffer_depth
        # per-graph immutables, hoisted: repeated run() calls on one
        # scheduler (the decode loop) must not rebuild these every step
        names = graph.names
        seq = {n: i for i, n in enumerate(names)}
        self._indeg0 = {n: graph.in_degree(n) for n in names}
        self._entry = {n: (-self.levels[n], seq[n], n) for n in names}
        self._ready0 = sorted(self._entry[n] for n in names if self._indeg0[n] == 0)
        self._total = len(graph)
        self._graph_version = graph.version

    def run(
        self,
        inputs: Mapping[str, Any] | None = None,
        *,
        pool: Any = None,
        deadline: float | None = None,
    ) -> HostRunResult:
        g = self.graph
        if g.version != self._graph_version:
            # the per-graph immutables above were hoisted to __init__; a
            # node added since would silently never execute
            raise RuntimeError(
                f"graph {g.name!r} mutated (version {self._graph_version} -> "
                f"{g.version}, {self._total} -> {len(g)} nodes) after "
                "HostScheduler construction — build a new scheduler"
            )
        inputs = dict(inputs or {})
        results: dict[str, Any] = {}
        indeg = dict(self._indeg0)
        entry = self._entry
        successors = g.successors

        ready: list[tuple[float, int, str]] = list(self._ready0)  # sorted => heap

        n_exec = self.n_executors
        pool = pool if pool is not None else self.pool
        ephemeral = pool is None
        if ephemeral:
            pool = ExecutorPool(n_exec)
        elif pool.n_executors < n_exec:
            raise ValueError(
                f"run needs {n_exec} executors but the pool has "
                f"{pool.n_executors}"
            )
        # CUDA executors: node outputs travel with the event recorded after
        # their launch; inputs are ordered behind the caller's stream
        streams = getattr(pool, "streams", None)
        events: dict[str, Any] = {}
        entry_ev = entry_event(pool.device) if streams is not None else None
        # depth is enforced per-run by the inflight counters, so the pool's
        # queues stay unbounded — shutdown puts never block on a full buffer
        triggered: queue.SimpleQueue = queue.SimpleQueue()
        inflight = [0] * n_exec
        depth = self.buffer_depth
        # idle-executor heap keyed (inflight, qsize-at-push, e): replaces the
        # O(n_exec) min(...) scan per dispatched op.  Entries go stale when
        # inflight changes; stale entries are discarded (and re-keyed) on
        # pop, so total heap traffic stays O(ops log n_exec).
        idle: list[tuple[int, int, int]] = sorted(
            (0, pool.qsize(e), e) for e in range(n_exec)
        )
        peak_inflight = 0
        trace: list[TraceEvent] = []
        t_origin = time.perf_counter()

        n_done = 0
        total = self._total

        def dispatch() -> None:
            """Fire ready ops highest-level-first at the least-loaded
            executors until every buffer is full or nothing is ready.
            Cross-run load on a shared pool shows up via ``pool.qsize``.
            Input passthroughs resolve inline — a serving decode step's
            dozens of input leaves must not each pay an executor
            round-trip."""
            nonlocal peak_inflight, n_done
            while ready:
                name = ready[0][2]
                node = g[name]
                if node.fn is None and name in inputs:
                    heapq.heappop(ready)
                    results[name] = inputs[name]
                    n_done += 1
                    for s in successors(name):
                        indeg[s] -= 1
                        if indeg[s] == 0:
                            heapq.heappush(ready, entry[s])
                    continue
                ex = -1
                while idle:
                    inf, _, e = idle[0]
                    if inf == inflight[e] and inf < depth:
                        ex = e
                        heapq.heappop(idle)
                        break
                    heapq.heappop(idle)  # stale: re-key if still usable
                    if inflight[e] < depth:
                        heapq.heappush(idle, (inflight[e], pool.qsize(e), e))
                if ex < 0:
                    return          # every buffer is full
                heapq.heappop(ready)
                if node.fn is None:
                    # no fn and no input: raises in the executor and is
                    # relayed like any other op failure
                    task: Any = partial(_input_lookup, inputs, name)
                elif streams is None:
                    task = partial(node.fn, *(results[d] for d in node.deps))
                else:
                    waits = dict.fromkeys(events.get(d, entry_ev) for d in node.deps)
                    task = partial(stream_call, node.fn,
                                   tuple(results[d] for d in node.deps), tuple(waits))
                inflight[ex] += 1
                if inflight[ex] < depth:
                    heapq.heappush(idle, (inflight[ex], pool.qsize(ex), ex))
                peak_inflight = max(peak_inflight, inflight[ex])
                pool.submit(ex, name, task, triggered, t_origin)

        try:
            dispatch()
            while n_done < total:
                # poll triggered operations (Alg. 1 line 2); drain every
                # completion that has already arrived so one dispatch round
                # can refill all newly-idle executors
                if deadline is None:
                    first = triggered.get()
                else:
                    # a per-run deadline bounds each wait: a hung op must
                    # poison this run (freeing its lease) instead of wedging
                    # the scheduler — and the pool behind it — forever
                    try:
                        first = triggered.get(
                            timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        busy = ""
                        if hasattr(pool, "current_tasks"):
                            cur = [c[0] for c in pool.current_tasks() if c]
                            busy = f"; executors busy in {cur!r}" if cur else ""
                        raise DeadlineExceeded(
                            f"graph {g.name!r}: deadline exceeded with "
                            f"{total - n_done} of {total} ops unfinished"
                            f"{busy}") from None
                completed = [first]
                while True:
                    try:
                        completed.append(triggered.get_nowait())
                    except queue.Empty:
                        break
                for name, out, ex, t0, t1 in completed:
                    if name is _ERR:
                        failing_op = t0
                        raise RuntimeError(
                            f"op {failing_op!r} failed on executor {ex}"
                        ) from out
                    if streams is not None and g[name].fn is not None:
                        out, events[name] = out
                    results[name] = out
                    inflight[ex] -= 1
                    heapq.heappush(idle, (inflight[ex], pool.qsize(ex), ex))
                    trace.append(TraceEvent(name, ex, t0, t1))
                    n_done += 1
                    for s in successors(name):
                        indeg[s] -= 1
                        if indeg[s] == 0:
                            heapq.heappush(ready, entry[s])
                dispatch()
            if streams is not None:
                join_streams(pool.device, streams, results.values())
        finally:
            if ephemeral:
                # on an exception path (op failure, deadline) the close must
                # not mask the in-flight error with a stuck-thread raise —
                # the unhealthy state is still recorded and logged
                pool.close(raise_on_stuck=sys.exc_info()[0] is None)

        makespan = max((e.end for e in trace), default=0.0)
        return HostRunResult(
            outputs=results, trace=trace, makespan=makespan,
            peak_inflight=max(peak_inflight, 1),
        )
