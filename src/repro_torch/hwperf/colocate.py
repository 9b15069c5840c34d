"""Co-location harness: run op-class workloads concurrently and measure the
slowdown each pair inflicts vs running alone.

This is the measured version of the paper's Fig 3 axis.  ``calibrate()``
times every op *solo*; here two workloads start behind a barrier, each on
its own pinned host thread, and each reports its own per-iteration time.
``pair / solo`` is the contention coefficient that
:mod:`repro_torch.hwperf.model` turns into a cost adjustment and a
placement policy.

On a CUDA card (the default) each workload runs on its own stream, fed
by its own pinned host thread — the shape of the runtime's executors, one
stream and one launcher thread each.  Each thread times its own window
of ``iters`` runs with CUDA events on its stream, and keeps its load on
after its window until its partner's window has closed on the device
too, so both windows see the other's load; one pair run gives both
directions.  ``launch`` says how a thread feeds its stream:

* ``"graph"`` (the default on a card) — the window is one CUDA graph of
  ``iters`` runs, captured before the threads start: one launch a window,
  so the two host threads do not contend and the slowdown is the card's
  alone (SMs, L2, HBM);
* ``"eager"`` — one Python call a kernel, as the runtime's executors
  launch today.  The two threads share one interpreter lock, so where a
  kernel is shorter than its launch the window also counts the host's
  feed rate and its contention.  ``InterferenceMatrix.solo_host`` keeps
  the host's seconds to enqueue a solo run, which says when a window was
  host-bound.

The workloads are sized like kernels of a decode step on the main path
(gemma-2b), not like kernels that fill the card: two kernels that each
fill all 132 SMs would only measure serialisation (about 2x).

* ``gemm`` — a ``[8, 2048] x [2048, 16384]`` bf16 product (gemma-2b's FFN
  up-projection at 8 decode rows: 64 MiB of weights streamed);
* ``elementwise`` — ``gelu(gate) * up`` over ``[512, 16384]`` bf16 (the
  FFN's gate of one 512-token gemma-2b prefill chunk: two kernels);
* ``memory`` — a copy of ``[18, 8, 1024, 256]`` bf16 (one of gemma-2b's
  K caches at 8 slots of 1024 tokens, 72 MiB: what a slot insert moves).

``device="cpu"`` runs the same harness, eager, on small CPU tensors (the
tests); a CPU run's numbers are host numbers.
"""
from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import torch

from .pinning import pin_current_thread
from .topology import CpuTopology, detect_topology, disjoint_core_sets

__all__ = [
    "Workload",
    "InterferenceMatrix",
    "default_workloads",
    "measure_interference",
    "LAUNCH_MODES",
]

# (rows, d_model, d_ff), (rows, d_ff), (layers, slots, tokens, head dim)
CARD_GEMM = (8, 2048, 16384)
CARD_ELEMENTWISE = (512, 16384)
CARD_MEMORY = (18, 8, 1024, 256)
LAUNCH_MODES = ("graph", "eager")
# background launches allowed in flight on the card: kernels when eager,
# whole graphs of ``iters`` runs when graphed
_IN_FLIGHT = {"eager": 8, "graph": 2}


@dataclass(frozen=True)
class Workload:
    """One op-class proxy: ``setup()`` builds state once, ``run(state)`` is
    the timed unit of work (enqueued on the current stream on a card)."""

    op_class: str
    setup: Callable[[], object]
    run: Callable[[object], object]


def default_workloads(*, device: str | torch.device = "cuda",
                      scale: int = 192) -> list[Workload]:
    """The three contended-resource proxies on ``device``: the decode-step
    sizes above on a card; on the CPU ``scale`` sets the matmul side /
    vector length (f32) so smoke runs finish in milliseconds."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n = max(32, scale)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def gemm_setup():
        g = gen(0)
        if cuda:
            m, k, f = CARD_GEMM
            kw = {"dtype": torch.bfloat16, "device": dev, "generator": g}
            return (torch.randn(m, k, **kw), torch.randn(k, f, **kw),
                    torch.empty(m, f, dtype=torch.bfloat16, device=dev))
        kw = {"dtype": torch.float32, "device": dev, "generator": g}
        return torch.randn(n, n, **kw), torch.randn(n, n, **kw), torch.empty(n, n)

    def gemm_run(state):
        a, b, out = state
        return torch.mm(a, b, out=out)

    def elem_setup():
        g = gen(1)
        shape, dtype = (CARD_ELEMENTWISE, torch.bfloat16) if cuda else ((n * n,), torch.float32)
        kw = {"dtype": dtype, "device": dev, "generator": g}
        return torch.randn(shape, **kw), torch.randn(shape, **kw), torch.empty(shape, dtype=dtype,
                                                                                 device=dev)

    def elem_run(state):
        gate, up, out = state
        return torch.mul(torch.nn.functional.gelu(gate, approximate="tanh"), up, out=out)

    def mem_setup():
        # streaming copy is bandwidth-bound: the contended resource for
        # memory-class ops (on the CPU large enough to spill L2 even scaled
        # down)
        g = gen(2)
        shape, dtype = (CARD_MEMORY, torch.bfloat16) if cuda else ((8 * n * n,), torch.float32)
        src = torch.randn(shape, dtype=dtype, device=dev, generator=g)
        return src, torch.empty_like(src)

    def mem_run(state):
        src, dst = state
        return dst.copy_(src)

    return [
        Workload("gemm", gemm_setup, gemm_run),
        Workload("elementwise", elem_setup, elem_run),
        Workload("memory", mem_setup, mem_run),
    ]


@dataclass
class InterferenceMatrix:
    """Solo medians and pairwise co-run medians, seconds per iteration.

    ``pair[(a, b)]`` is *a*'s per-iteration time while *b* runs beside it —
    asymmetric by construction (a matmul barely notices a copy loop; the
    copy loop notices the matmul's bandwidth).  ``device`` says where the
    workloads ran (``"cpu"``, or the card's name), ``launch`` how their
    threads fed it, and ``solo_host`` each class's host seconds per
    iteration to enqueue its solo window (on the CPU, its run time).
    """

    solo: dict[str, float] = field(default_factory=dict)
    pair: dict[tuple[str, str], float] = field(default_factory=dict)
    pinned: bool = False
    disjoint: bool = False
    device: str = "cpu"
    launch: str = "eager"
    solo_host: dict[str, float] = field(default_factory=dict)

    def slowdown(self, a: str, b: str) -> float:
        """How much slower ``a`` runs beside ``b`` than alone (>= 1.0 when
        there is contention; clamped below at 1.0 — timer noise must not
        turn co-location into a speedup)."""
        base = self.solo.get(a)
        co = self.pair.get((a, b))
        if not base or co is None:
            return 1.0
        return max(1.0, co / base)

    def classes(self) -> list[str]:
        return sorted(self.solo)


class _Clock:
    """Per-thread timestamps: CUDA events on the thread's stream on a card
    (device time of the enqueued work), the host clock on the CPU."""

    def __init__(self, stream):
        self.stream = stream

    def mark(self):
        if self.stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def done(self, t) -> bool:
        """Whether the work before mark ``t`` has run (always, on the CPU)."""
        return self.stream is None or t.query()

    def seconds(self, t0, t1) -> float:
        if self.stream is None:
            return t1 - t0
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3


@dataclass
class _Feed:
    """One thread's load: ``window()`` enqueues the ``iters`` timed runs,
    ``more()`` the load kept on around it (one run when eager, the whole
    graph again when graphed).  ``state`` holds the workload's tensors for
    as long as a graph that reads them may be replayed."""

    window: Callable[[], None]
    more: Callable[[], None]
    in_flight: int
    state: object = None


def _eager_feed(wl: Workload, state, iters: int) -> _Feed:
    def window() -> None:
        for _ in range(iters):
            wl.run(state)

    return _Feed(window, lambda: wl.run(state), _IN_FLIGHT["eager"], state)


def _graph_feed(wl: Workload, state, iters: int, dev: torch.device) -> _Feed:
    """Capture ``iters`` runs of ``wl`` into one CUDA graph, after two runs
    on a side stream (library handles, allocator) as capture wants."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            wl.run(state)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            wl.run(state)
    return _Feed(graph.replay, graph.replay, _IN_FLIGHT["graph"], state)


def _timed_loop(feed: _Feed, iters: int, barrier: threading.Barrier, cpus, stream,
                out: dict, key: str, closed: list[threading.Event]) -> None:
    """One measurement thread: pin, warm, sync on the barrier, time its
    window, then keep its load on until every thread's window has closed
    on the device (``closed``).  A failure breaks the barrier and closes
    every window, so no partner waits for it, and is handed to the caller."""
    me = closed[int(key)]
    try:
        if cpus:
            out[f"{key}_pinned"] = pin_current_thread(cpus)
        if stream is not None:
            torch.cuda.set_device(stream.device)    # a new thread has no current context
        clock = _Clock(stream)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            feed.more()                 # warm caches / allocator before the barrier
            if stream is not None:
                stream.synchronize()
            barrier.wait()
            t0, h0 = clock.mark(), time.perf_counter()
            feed.window()
            h1, t1 = time.perf_counter(), clock.mark()
            flight: deque = deque()
            while True:
                if not me.is_set() and clock.done(t1):
                    me.set()
                if all(e.is_set() for e in closed):
                    break
                feed.more()
                if stream is not None:
                    flight.append(clock.mark())
                    if len(flight) > feed.in_flight:
                        flight.popleft().synchronize()
            out[key] = clock.seconds(t0, t1) / iters
            out[f"{key}_host"] = (h1 - h0) / iters
    except Exception as e:  # noqa: BLE001 — reported by _run_together
        out[f"{key}_error"] = e
        barrier.abort()
        for ev in closed:
            ev.set()


def _run_together(feeds: list[_Feed], cpu_sets: list, streams: list,
                  iters: int) -> tuple[list[float], list[float], list[bool]]:
    """Start one thread per feed behind a barrier; each reports its own
    per-iteration time.  Returns (device times, host enqueue times, pin
    results)."""
    k = len(feeds)
    barrier = threading.Barrier(k)
    closed = [threading.Event() for _ in range(k)]
    out: dict = {}
    threads = [threading.Thread(
        target=_timed_loop, args=(f, iters, barrier, cpus, s, out, str(i), closed),
        daemon=True) for i, (f, cpus, s) in enumerate(zip(feeds, cpu_sets, streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors = [out[f"{i}_error"] for i in range(k) if f"{i}_error" in out]
    if errors:
        raise RuntimeError(f"a co-location thread failed: {errors[0]!r}") from errors[0]
    pins = [out[f"{i}_pinned"] for i in range(k) if f"{i}_pinned" in out]
    return [out[str(i)] for i in range(k)], [out[f"{i}_host"] for i in range(k)], pins


def measure_interference(
    workloads: list[Workload] | None = None,
    topology: CpuTopology | None = None,
    *,
    iters: int | None = None,
    repeats: int = 3,
    pinned: bool = True,
    device: str | torch.device = "cuda",
    launch: str | None = None,
) -> InterferenceMatrix:
    """Measure solo and pairwise co-run times for every workload pair.

    Each class runs solo, then each unordered pair (a class beside itself
    included) runs once per repeat, both threads timing themselves: 3
    classes give 3 solo and 6 pair measurements a repeat.  Each
    measurement keeps the median of ``repeats`` — a single descheduling
    event must not become a contention coefficient.  ``iters`` (timed runs
    per window) defaults to 200 on a card and 20 on the CPU.  ``launch``
    (``"graph"`` or ``"eager"``, see the module docstring) defaults to
    ``"graph"`` on a card; the CPU has only ``"eager"``.  With
    ``pinned=False`` (or where affinity is unsupported) threads run
    OS-scheduled; the matrix records which mode actually happened.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("measure_interference(device='cuda') needs a CUDA device")
    launch = launch if launch is not None else ("graph" if cuda else "eager")
    if launch not in LAUNCH_MODES or (launch == "graph" and not cuda):
        raise ValueError(f"launch={launch!r}: one of {LAUNCH_MODES}, 'graph' on a card only")
    iters = iters if iters is not None else (200 if cuda else 20)
    wls = workloads if workloads is not None else default_workloads(device=dev)
    topo = topology if topology is not None else detect_topology()
    sets = disjoint_core_sets(topo, 2)
    cpu_sets = [sets[0], sets[1]] if pinned else [None, None]
    disjoint = pinned and not set(sets[0]) & set(sets[1])

    def feed(wl: Workload) -> _Feed:
        state = wl.setup()
        if launch == "graph":
            return _graph_feed(wl, state, iters, dev)
        return _eager_feed(wl, state, iters)

    feeds = [feed(wl) for wl in wls]
    twins = [feed(wl) for wl in wls]       # a class beside itself: its own buffers
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)] if cuda else [None, None]
    if cuda:
        torch.cuda.synchronize(dev)

    m = InterferenceMatrix(pinned=False, disjoint=disjoint, launch=launch,
                           device=torch.cuda.get_device_name(dev) if cuda else "cpu")
    pin_results: list[bool] = []
    for i, wl in enumerate(wls):
        runs, host = [], []
        for _ in range(repeats):
            (t,), (h,), pins = _run_together([feeds[i]], cpu_sets[:1], streams[:1], iters)
            runs.append(t)
            host.append(h)
            pin_results.extend(pins)
        m.solo[wl.op_class] = statistics.median(runs)
        m.solo_host[wl.op_class] = statistics.median(host)
    for i, a in enumerate(wls):
        for j in range(i, len(wls)):
            b = wls[j]
            ta, tb = [], []
            for _ in range(repeats):
                (x, y), _, pins = _run_together([feeds[i], twins[j] if i == j else feeds[j]],
                                                cpu_sets, streams, iters)
                ta.append(x)
                tb.append(y)
                pin_results.extend(pins)
            if i == j:                     # both threads ran the same class
                m.pair[(a.op_class, a.op_class)] = statistics.median(ta + tb)
            else:
                m.pair[(a.op_class, b.op_class)] = statistics.median(ta)
                m.pair[(b.op_class, a.op_class)] = statistics.median(tb)
    # "pinned" only when every attempted pin actually took — a matrix
    # measured with OS-rejected pins is an unpinned measurement
    m.pinned = bool(pin_results) and all(pin_results)
    return m
