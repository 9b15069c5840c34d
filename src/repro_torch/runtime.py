"""``repro_torch.Runtime`` — one process-wide runtime that owns executors,
calibration, and admission for every graph.

The paper's core claim is that concurrent operations must share a manycore
machine *without interference*.  A :class:`Runtime` holds the per-process
state every entry point shares:

* **One** :class:`~repro_torch.core.engine.ExecutorPool` sized to the
  device: on a CUDA device one stream per executor (see
  :func:`_card_workers` for the count), on the CPU one thread per core.
  Every graph run in the process executes on these threads; nothing else
  spawns executors.
* A persistent :class:`CalibrationStore` — measured per-op costs keyed by a
  structural :func:`graph_signature` — with JSON save/load, so
  ``Executable.calibrate`` survives process restarts and is shared across
  executables of the same graph.
* The per-(graph, width) ``StaticHostPlan`` / ``HostScheduler`` caches, so
  two executables over one graph freeze placements once.
* An **admission layer**: each run asks for an :class:`ExecutorLease` — a
  *disjoint subset* of the pool's executors sized by the run's calibrated
  CPF width.  CPF scheduling happens inside the lease; leases queue (FIFO,
  no barging) rather than oversubscribe, so a decode step and a train step
  share the pool with bounded interference instead of fighting for threads.

``repro_torch.compile(...)`` is sugar over ``default_runtime().compile(...)``;
components that want an isolated pool (tests, benches) construct their own
``Runtime`` and pass it around.  A runtime runs on the card unless it is
built with ``device="cpu"``.  ``pinning`` places the executor threads on
disjoint host cores (:mod:`repro_torch.hwperf`: on a card, the launcher
thread of each stream), and a measured contention model in the
calibration store makes the ``cpf-contention`` placement policy
resolvable.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.cost_model import H100, KNL7250, HardwareModel
from repro_torch.core.engine import DeadlineExceeded, ExecutorPool
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device

__all__ = [
    "AdmissionRejected",
    "CalibrationStore",
    "DeadlineExceeded",
    "ExecutorLease",
    "Runtime",
    "default_runtime",
    "graph_signature",
    "set_default_runtime",
]


class AdmissionRejected(RuntimeError):
    """Admission shed this request instead of queueing it (429-style).

    Raised by :meth:`Runtime.lease` when the estimated queue wait exceeds
    the caller's latency budget: under overload it is better to reject
    *now* with a :attr:`retry_after` hint than to accept work whose latency
    is already blown.  ``retry_after`` is jittered (seeded, deterministic
    per runtime) so a thundering herd of rejected callers does not retry in
    lock-step."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


def graph_signature(graph: Graph, variant: str = "") -> str:
    """Stable structural hash of a graph: node names, kinds, deps, and the
    roofline stats that drive the cost model.

    Two captures of the same function at the same shapes produce the same
    signature, so a :class:`CalibrationStore` entry written by one process
    seeds the schedule of the next.  ``variant`` salts the key for
    executions whose per-op cost differs at identical structure (e.g.
    ``jit_nodes=True`` runs every fn as a generated ``GraphModule`` —
    dispatch cost, not flops, dominates tiny ops, so the two tables must
    not mix).
    """
    h = hashlib.sha256()
    h.update(variant.encode())
    for name in graph.names:
        nd = graph[name]
        h.update(
            f"{name}|{nd.kind}|{nd.flops:.6g}|{nd.bytes_in:.6g}|"
            f"{nd.bytes_out:.6g}|{','.join(nd.deps)}\n".encode()
        )
    return h.hexdigest()


class CalibrationStore:
    """Measured op-cost tables and searched-schedule winners, keyed by
    :func:`graph_signature`.

    Each signature owns two sections (JSON ``format: 3``):

    * ``costs`` — ``{op_name: seconds}`` from
      :func:`~repro_torch.core.profiler.measure_op_costs`;
    * ``schedule`` — searched-winner records from
      :func:`~repro_torch.core.search.search_schedule`, keyed by a *config key*
      (width × team × cost fingerprint, see ``api._cost_fp``): the
      ``{policy, seed, makespan_sim, runner_up_gap}`` dict that replays the
      winning schedule deterministically, so the simulator search runs once
      per (graph, executor config, cost model) across processes.

    Format 3 adds one machine-wide top-level section, ``interference`` —
    the measured contention model of :mod:`repro_torch.hwperf` (per-op-class
    solo times and pairwise co-run slowdowns; the JAX package's format, so
    files written by either package load in both).  It is machine state, not graph state, so it lives
    beside ``entries``, not inside them.

    Format-1 files (bare ``{sig: {op: seconds}}`` entries) and format-2
    files (no ``interference`` section) still load — they migrate in
    memory (costs and schedules are never lost to a format bump; the
    interference section starts empty) and are rewritten as format 3 on
    the next save.  Unknown *future* formats raise a :class:`ValueError`
    naming the file rather than guessing.

    With a ``path`` the store loads existing entries at construction and
    autosaves (atomic tmp+rename) on every :meth:`put` /
    :meth:`put_schedule`.  Thread-safe: a serve engine calibrating and a
    trainer reading may race.
    """

    _FORMAT = 3

    def __init__(self, path: str | None = None):
        self.path = path
        self._entries: dict[str, dict[str, float]] = {}
        # signature -> config_key -> winner record (JSON-able dict)
        self._schedules: dict[str, dict[str, dict]] = {}
        # machine-wide measured contention model (ContentionModel.to_dict());
        # empty dict = "measured nothing yet", kept distinct from format-2
        # files that predate the section (also loaded as empty)
        self._interference: dict = {}
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()   # serializes concurrent save()s
        if path is not None and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, signature: str) -> bool:
        return signature in self._entries

    def get(self, signature: str) -> dict[str, float] | None:
        with self._lock:
            costs = self._entries.get(signature)
            return dict(costs) if costs is not None else None

    def put(self, signature: str, costs: Mapping[str, float]) -> None:
        with self._lock:
            self._entries[signature] = {k: float(v) for k, v in costs.items()}
        if self.path is not None:
            self.save(self.path)

    def get_interference(self) -> dict | None:
        """The machine-wide measured contention section
        (``ContentionModel.to_dict()`` shape), or ``None`` when nothing has
        been measured (including stores migrated from formats 1/2)."""
        with self._lock:
            return dict(self._interference) if self._interference else None

    def put_interference(self, section: Mapping) -> None:
        """Persist a measured contention model (the whole section replaces
        the old one — coefficients from two different measurement runs must
        not interleave)."""
        with self._lock:
            self._interference = dict(section)
        if self.path is not None:
            self.save(self.path)

    def get_schedule(self, signature: str, config_key: str) -> dict | None:
        """The persisted search winner for (graph signature, config key),
        or ``None`` when that search has not run yet."""
        with self._lock:
            rec = self._schedules.get(signature, {}).get(config_key)
            return dict(rec) if rec is not None else None

    def put_schedule(self, signature: str, config_key: str, record: Mapping) -> None:
        """Persist a search winner (callers verify via ``repro_torch.checks``
        *before* putting — the store holds only vetted schedules)."""
        with self._lock:
            self._schedules.setdefault(signature, {})[config_key] = dict(record)
        if self.path is not None:
            self.save(self.path)

    def save(self, path: str | None = None) -> str:
        path = path if path is not None else self.path
        if path is None:
            raise ValueError("CalibrationStore has no path; pass save(path)")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # pid + thread id: concurrent savers (two executables calibrating
        # on one runtime) must never truncate each other's tmp file
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        # snapshot *inside* the io lock: replace order then matches snapshot
        # order, so the file on disk is always the newest state a saver saw
        # (snapshotting outside would let a stale snapshot win the last
        # replace under concurrent put()s)
        with self._io_lock:
            with self._lock:
                sigs = set(self._entries) | set(self._schedules)
                entries = {
                    sig: {
                        "costs": self._entries.get(sig, {}),
                        "schedule": self._schedules.get(sig, {}),
                    }
                    for sig in sigs
                }
                payload = {
                    "format": self._FORMAT,
                    "entries": entries,
                    "interference": dict(self._interference),
                }
                blob = json.dumps(payload, indent=1, sort_keys=True)
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        return path

    def load(self, path: str | None = None) -> int:
        """Merge entries from ``path`` (disk wins); returns the entry count.

        Accepts the current format 3 and migrates format-1 (bare cost
        tables) and format-2 (no interference section) files — measured
        seconds and searched schedules are never lost to a format bump; any
        other format raises a :class:`ValueError` naming the file.
        """
        path = path if path is not None else self.path
        if path is None:
            raise ValueError("CalibrationStore has no path; pass load(path)")
        with open(path) as f:
            payload = json.load(f)
        fmt = payload.get("format")
        costs_in: dict[str, dict[str, float]] = {}
        scheds_in: dict[str, dict[str, dict]] = {}
        interference_in: dict = {}
        if fmt == 1:
            # format 1: entries are bare {sig: {op: seconds}} cost tables
            for sig, costs in payload["entries"].items():
                costs_in[sig] = {k: float(v) for k, v in costs.items()}
        elif fmt in (2, self._FORMAT):
            # format 2 is format 3 minus the interference section: one
            # parse, sections default empty
            for sig, section in payload["entries"].items():
                costs_in[sig] = {
                    k: float(v) for k, v in section.get("costs", {}).items()
                }
                sch = section.get("schedule", {})
                if sch:
                    scheds_in[sig] = {ck: dict(rec) for ck, rec in sch.items()}
            interference_in = dict(payload.get("interference", {}))
        else:
            raise ValueError(
                f"calibration store {path!r} has format {fmt!r}; this build "
                f"reads formats 1, 2 and {self._FORMAT}"
            )
        with self._lock:
            # a format-2 sig may be schedule-only: an empty costs section
            # must not shadow (or fabricate) a measured table
            self._entries.update({s: c for s, c in costs_in.items() if c})
            for sig, by_cfg in scheds_in.items():
                self._schedules.setdefault(sig, {}).update(by_cfg)
            if interference_in:
                self._interference = interference_in
            return len(self._entries)


class _Admission:
    """FIFO executor leasing over one pool's executor ids.

    ``acquire(width)`` blocks until this request is at the **head** of the
    queue *and* ``width`` executors are free — strict FIFO, so a wide
    request is never starved by narrow ones barging past it, and total
    leased executors never exceed the pool (no oversubscription, the whole
    point of the admission layer).

    Robustness state on top of the free set:

    * **quarantine** — executors whose threads are still inside an op a
      deadline-aborted run abandoned.  They are *not* free (handing one out
      would give the next run a busy thread) and *not* leased; they heal
      automatically: every acquire/estimate probes the pool
      (:meth:`ExecutorPool.current_tasks`) and returns idle-again
      quarantined executors to the free set.
    * **leak accounting** — ``release`` of an id that is not out on a lease
      (double release, corrupt release) is counted and ignored instead of
      corrupting the free set; ids that never come back (a lease that lost
      them) are recovered by :meth:`reclaim` against the set of live
      leases, after a grant grace period.
    * **load estimate** — an EWMA of lease hold times turns queue depth
      into an expected wait, which :meth:`Runtime.lease` compares against a
      latency budget to shed (429-style) instead of queueing.
    """

    def __init__(self, n_executors: int, *, seed: int = 0,
                 reclaim_grace: float = 0.25):
        self.n_executors = n_executors
        self._free: set[int] = set(range(n_executors))
        self._cond = threading.Condition()
        self._queue: deque[object] = deque()
        self._quarantined: set[int] = set()
        self._granted_at: dict[int, float] = {}
        self._probe: Callable[[], list] | None = None   # pool.current_tasks
        self._hold_ewma = 0.0
        self._rng = random.Random(seed)                  # retry-after jitter
        self.reclaim_grace = reclaim_grace
        self.n_bad_releases = 0
        self.n_leaks_reclaimed = 0
        self.n_shed = 0

    def attach_probe(self, probe: Callable[[], list]) -> None:
        """Wire the pool's ``current_tasks`` snapshot in (set once, at pool
        creation): quarantined executors heal by observing it."""
        self._probe = probe

    @property
    def n_free(self) -> int:
        with self._cond:
            return len(self._free)

    @property
    def n_waiting(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def n_quarantined(self) -> int:
        with self._cond:
            return len(self._quarantined)

    def _heal_locked(self) -> None:
        """Return quarantined executors whose hung op has finally finished
        (their thread is idle again) to the free set.  Lock held."""
        if not self._quarantined or self._probe is None:
            return
        cur = self._probe()
        healed = {e for e in self._quarantined if cur[e] is None}
        if healed:
            self._quarantined.difference_update(healed)
            self._free.update(healed)
            self._cond.notify_all()

    def estimated_wait(self, width: int) -> float:
        """Expected queue wait for a ``width`` lease right now: zero when it
        would be granted immediately, else queue depth times the EWMA of
        recent lease hold times.  Deliberately coarse — a shed decision
        needs the order of magnitude, not the schedule."""
        with self._cond:
            self._heal_locked()
            if not self._queue and len(self._free) >= width:
                return 0.0
            return (len(self._queue) + 1) * max(self._hold_ewma, 1e-3)

    def retry_after(self, estimate: float) -> float:
        """Jittered (seeded — deterministic per admission instance) backoff
        hint for a shed caller: 0.5x-1.5x the current wait estimate."""
        with self._cond:
            self.n_shed += 1
            return max(estimate, 1e-3) * (0.5 + self._rng.random())

    def acquire(
        self,
        width: int,
        timeout: float | None = None,
        prefer: tuple[int, ...] = (),
        deadline: float | None = None,
    ) -> tuple[int, ...]:
        if width < 1:
            raise ValueError(f"need width >= 1, got {width}")
        width = min(width, self.n_executors)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            timeout = remaining if timeout is None else min(timeout, remaining)
        ticket = object()
        with self._cond:
            self._heal_locked()
            if (width > self.n_executors - len(self._quarantined)
                    and timeout is None):
                # unsatisfiable until quarantined executors heal: without a
                # timeout this wait could be forever — fail loudly instead
                raise RuntimeError(
                    f"lease of width {width} unsatisfiable: "
                    f"{len(self._quarantined)} of {self.n_executors} "
                    "executors quarantined (threads stuck in abandoned ops)"
                )
            self._queue.append(ticket)

            def ready() -> bool:
                self._heal_locked()
                return self._queue[0] is ticket and len(self._free) >= width

            try:
                ok = self._cond.wait_for(ready, timeout=timeout)
            except BaseException:
                # e.g. KeyboardInterrupt mid-wait: an orphaned ticket at the
                # queue head would wedge strict-FIFO admission forever
                self._queue.remove(ticket)
                self._cond.notify_all()
                raise
            if not ok:
                self._queue.remove(ticket)
                self._cond.notify_all()
                raise TimeoutError(
                    f"no lease of width {width} within {timeout}s "
                    f"({len(self._free)} free, {len(self._queue)} waiting, "
                    f"{len(self._quarantined)} quarantined)"
                )
            self._queue.popleft()
            # sticky leases: grant the caller's previous executors when they
            # are free (warm threads / cache affinity — a replayed graph
            # should not migrate between executors run to run), then fill
            # from the free set
            picked = [e for e in prefer if e in self._free][:width]
            if len(picked) < width:
                rest = sorted(self._free.difference(picked))
                picked.extend(rest[: width - len(picked)])
            ids = tuple(sorted(picked))
            self._free.difference_update(ids)
            now = time.monotonic()
            for e in ids:
                self._granted_at[e] = now
            # the next waiter may already be satisfiable (narrower request)
            self._cond.notify_all()
            return ids

    def release(self, ids: tuple[int, ...], held: float | None = None) -> None:
        with self._cond:
            # a release of ids that are not out on a lease (double release,
            # corrupt release) is counted and *ignored* — updating the free
            # set from a bad release would let leased executors be granted
            # twice
            good = [e for e in ids
                    if e not in self._free and e not in self._quarantined]
            self.n_bad_releases += len(ids) - len(good)
            self._free.update(good)
            for e in good:
                self._granted_at.pop(e, None)
            if held is not None and good:
                a = 0.2
                self._hold_ewma = (held if self._hold_ewma == 0.0
                                   else (1 - a) * self._hold_ewma + a * held)
            self._cond.notify_all()

    def quarantine(self, ids: tuple[int, ...]) -> None:
        """Move leased executors whose threads are stuck inside an abandoned
        op out of circulation; they heal via :meth:`_heal_locked` when the
        op eventually returns."""
        with self._cond:
            for e in ids:
                if e not in self._free:
                    self._quarantined.add(e)
                    self._granted_at.pop(e, None)
            self._cond.notify_all()

    def reclaim(self, expected_live: set[int]) -> int:
        """Recover leaked executor ids: leased-out ids no live lease claims
        (a corrupt release dropped them, or a lease object was lost).  Only
        ids granted more than ``reclaim_grace`` seconds ago are eligible, so
        a grant racing its lease-object registration is never torn away."""
        now = time.monotonic()
        with self._cond:
            leased = (set(range(self.n_executors)) - self._free
                      - self._quarantined)
            leaked = {
                e for e in leased - expected_live
                if now - self._granted_at.get(e, now) > self.reclaim_grace
            }
            if leaked:
                self._free.update(leaked)
                for e in leaked:
                    self._granted_at.pop(e, None)
                self.n_leaks_reclaimed += len(leaked)
                self._cond.notify_all()
            return len(leaked)


class ExecutorLease:
    """A disjoint slice of a :class:`Runtime`'s executor pool.

    Quacks like an :class:`~repro_torch.core.engine.ExecutorPool` of
    ``len(executor_ids)`` executors — ``submit`` / ``submit_segments`` /
    ``qsize`` remap local executor indices onto the leased global ids — so
    both host runtimes (the dynamic :class:`HostScheduler` and compiled
    :class:`StaticHostPlan` segments) run *inside* the lease unchanged.
    Segment atomicity is inherited from the underlying pool's lock, so a
    leased plan still cannot cross-deadlock with anything else on the pool.

    ``close()`` aliases :meth:`release` so a lease can stand in anywhere a
    pool is owned; releasing twice is a no-op.
    """

    def __init__(self, runtime: "Runtime", executor_ids: tuple[int, ...]):
        self._runtime = runtime
        self._pool = runtime.pool
        self.executor_ids = executor_ids
        self.n_executors = len(executor_ids)
        self.device = self._pool.device
        self.streams = (None if self._pool.streams is None
                        else [self._pool.streams[g] for g in executor_ids])
        self._granted = time.monotonic()
        self._released = False

    def submit(self, ex: int, name: str, task: Callable[[], Any],
               reply: Any, t_origin: float) -> None:
        self._pool.submit(self.executor_ids[ex], name, task, reply, t_origin)

    def submit_segments(self, items: list, reply: Any, t_origin: float) -> None:
        self._pool.submit_segments(
            [(self.executor_ids[e], name, task) for e, name, task in items],
            reply, t_origin,
        )

    def qsize(self, ex: int) -> int:
        return self._pool.qsize(self.executor_ids[ex])

    def current_tasks(self) -> list[tuple[str, float] | None]:
        """What each *leased* executor is running (local index order)."""
        cur = self._pool.current_tasks()
        return [cur[g] for g in self.executor_ids]

    @property
    def outstanding_ids(self) -> tuple[int, ...]:
        """Global executor ids this lease still owes back; the currency
        :meth:`Runtime.reclaim_leaks` reconciles against."""
        return () if self._released else self.executor_ids

    def release(self, *, quarantine_busy: bool = False) -> None:
        """Give the executors back.  ``quarantine_busy=True`` is the
        deadline-abort path: leased executors whose threads are *still
        inside an op* go to admission quarantine (they would hand the next
        run a busy thread) and only the idle ones return to the free set.
        Releasing twice is a no-op."""
        if self._released:
            return
        self._released = True
        held = time.monotonic() - self._granted
        adm = self._runtime._admission
        if quarantine_busy:
            cur = self._pool.current_tasks()
            busy = tuple(g for g in self.executor_ids if cur[g] is not None)
            if busy:
                adm.quarantine(busy)
            idle = tuple(g for g in self.executor_ids if g not in busy)
            if idle:
                adm.release(idle, held=held)
            return
        adm.release(self.executor_ids, held=held)

    # pool-interface compatibility: components that "own" their pool call
    # close(); for a lease that means giving the executors back
    close = release

    def __enter__(self) -> "ExecutorLease":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ExecutorLease(ids={self.executor_ids}, "
                f"released={self._released})")


def _machine_workers() -> int:
    # at least 2 so every machine exercises real multi-executor placement
    return max(2, os.cpu_count() or 2)


def _card_workers(device: torch.device) -> int:
    """Executor count on a CUDA device: one stream per 33 SMs (4 on an
    H100's 132), at least 2.  Not the host's core count: every executor is
    a stream fed by one host thread, and the host threads share one
    interpreter lock, so more streams than this add launch contention
    without adding device parallelism — at decode sizes one kernel fills
    far fewer than 33 SMs, and four concurrent kernels already leave most
    of the card to whichever one is largest."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(2, sms // 33)


class Runtime:
    """Process-wide session owning executors, calibration, and admission.

    Parameters
    ----------
    n_workers:
        Executor count of the single shared pool (default: sized from the
        card on CUDA, :func:`_card_workers`; the core count, floor 2, on the
        CPU).  This is the hard bound the admission layer enforces: total
        leased executors never exceed it.
    hw:
        Default :class:`HardwareModel` for ``compile`` (cost model +
        config-search worker count); default :data:`H100` on CUDA,
        :data:`KNL7250` on the CPU.
    device:
        ``"cuda"`` (default; raises without a CUDA device) or ``"cpu"``.
    calibration_path:
        JSON file backing the :class:`CalibrationStore`.  Loaded at
        construction when it exists; autosaved on every ``calibrate()``.
    pinning:
        Executor-thread core pinning (paper §3.1): ``"off"`` (default —
        OS-scheduled), ``"auto"`` (pin when the platform supports affinity,
        silently run unpinned otherwise), or ``"on"`` (pin, with a single
        warning where unsupported).  On a card each executor thread is the
        host launcher of one stream.  Applied when the pool is created;
        :attr:`pinning_applied` records what actually happened.

    The executor pool is created lazily on first host execution, so
    sim-only runtimes never spawn threads or streams.  When the
    calibration store carries a measured ``interference`` section, the
    ``cpf-contention`` placement policy (:mod:`repro_torch.hwperf.model`) is
    installed in the policy registry at construction, so
    ``policy="cpf-contention"`` resolves for every executable on this
    runtime.
    """

    PINNING_MODES = ("off", "auto", "on")

    def __init__(
        self,
        n_workers: int | None = None,
        *,
        hw: HardwareModel | None = None,
        device: str | torch.device = "cuda",
        reserved_workers: int = 2,
        calibration_path: str | None = None,
        shed_after_s: float | None = None,
        seed: int = 0,
        pinning: str = "off",
    ):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        if n_workers is None:
            n_workers = _card_workers(self.device) if cuda else _machine_workers()
        self.n_workers = n_workers
        if self.n_workers < 1:
            raise ValueError(f"need >= 1 worker, got {self.n_workers}")
        if pinning not in self.PINNING_MODES:
            raise ValueError(
                f"pinning must be one of {self.PINNING_MODES}, got {pinning!r}")
        self.hw = hw if hw is not None else (H100 if cuda else KNL7250)
        self.reserved_workers = reserved_workers
        self.pinning = pinning
        self.pinning_applied = None   # hwperf.AppliedPinning once the pool pins
        self._contention_model = None
        self.calibration = CalibrationStore(calibration_path)
        if self.calibration.get_interference() is not None:
            # measured contention on disk: make "cpf-contention" resolvable
            self._install_contention()
        # default latency budget for lease admission: when the estimated
        # queue wait exceeds it, lease() sheds (AdmissionRejected with a
        # jittered retry_after) instead of queueing.  None = never shed.
        self.shed_after_s = shed_after_s
        self._pool: ExecutorPool | None = None
        self._pool_lock = threading.Lock()
        self._admission = _Admission(self.n_workers, seed=seed)
        self._live_leases: "weakref.WeakSet[ExecutorLease]" = weakref.WeakSet()
        self._cache_lock = threading.Lock()
        self._closed = False

    # -- executors + admission ----------------------------------------------
    @property
    def pool(self) -> ExecutorPool:
        """The one shared pool (created on first use)."""
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    if self._closed:
                        raise RuntimeError("Runtime is closed")
                    pool = ExecutorPool(self.n_workers, device=self.device)
                    # quarantined executors heal by observing the pool's
                    # per-executor busy state
                    self._admission.attach_probe(pool.current_tasks)
                    self._pool = pool
                    if self.pinning != "off":
                        self._apply_pinning(pool)
        return self._pool

    def _apply_pinning(self, pool: ExecutorPool) -> None:
        """Pin the pool's executor threads per :attr:`pinning` (lazy import:
        sim-only runtimes never touch hwperf)."""
        from repro_torch.hwperf import pinning as hwpin

        if self.pinning == "auto" and not hwpin.affinity_supported():
            return   # auto = best-effort, silent where unsupported
        plan = hwpin.plan_pinning(self.n_workers)
        self.pinning_applied = hwpin.pin_pool(pool, plan)

    def set_pinning(self, mode: str) -> None:
        """Change the pinning mode; applies immediately when the pool is
        already live (``api.compile(pinning=...)`` threads through here)."""
        if mode not in self.PINNING_MODES:
            raise ValueError(
                f"pinning must be one of {self.PINNING_MODES}, got {mode!r}")
        self.pinning = mode
        if self._pool is not None and mode != "off":
            self._apply_pinning(self._pool)

    # -- measured contention -------------------------------------------------
    def contention_model(self):
        """The measured :class:`~repro_torch.hwperf.model.ContentionModel`
        from the calibration store's ``interference`` section, or ``None``
        when nothing has been measured.  Cached; invalidated by
        :meth:`set_contention_model`."""
        if self._contention_model is None:
            section = self.calibration.get_interference()
            if section is not None:
                from repro_torch.hwperf.model import ContentionModel

                self._contention_model = ContentionModel.from_dict(section)
        return self._contention_model

    def set_contention_model(self, model) -> None:
        """Adopt a freshly measured contention model: persist it to the
        calibration store and (re)install the ``cpf-contention`` placement
        policy over it."""
        self.calibration.put_interference(model.to_dict())
        self._contention_model = model
        self._install_contention()

    def _install_contention(self) -> None:
        from repro_torch.hwperf.model import install_contention_policy

        model = self.contention_model()
        if model is not None:
            install_contention_policy(model)

    def lease(
        self,
        width: int,
        timeout: float | None = None,
        prefer: tuple[int, ...] = (),
        *,
        deadline: float | None = None,
        shed_after_s: float | None = None,
    ) -> ExecutorLease:
        """Lease ``width`` executors (clamped to ``n_workers``); blocks in
        FIFO order until that many are free.  ``prefer`` are the caller's
        previous executor ids — granted first when free, so a replayed
        graph keeps warm executor threads instead of migrating.  Use as a
        context manager or call ``release()``; every host run through this
        runtime holds exactly one lease for its duration.

        ``deadline`` (absolute, ``time.monotonic``) caps the queue wait on
        top of ``timeout``.  ``shed_after_s`` (defaulting to the runtime's
        ``shed_after_s``) is the admission latency budget: when the
        estimated queue wait exceeds it, raise :class:`AdmissionRejected`
        immediately — with a jittered ``retry_after`` — instead of joining
        a queue whose latency is already blown."""
        if self._closed:
            raise RuntimeError("Runtime is closed")
        _ = self.pool  # materialize before handing out ids
        budget = shed_after_s if shed_after_s is not None else self.shed_after_s
        if budget is not None:
            est = self._admission.estimated_wait(width)
            if est > budget:
                raise AdmissionRejected(
                    f"admission queue wait ~{est:.3f}s exceeds latency "
                    f"budget {budget:.3f}s ({self._admission.n_waiting} "
                    "waiting) — shed",
                    retry_after=self._admission.retry_after(est),
                )
        if self._admission.n_free < width:
            # under pressure, reconcile first: a corrupt or lost release
            # must shrink capacity only until detected, not forever
            self.reclaim_leaks()
        ids = self._admission.acquire(width, timeout=timeout, prefer=prefer,
                                      deadline=deadline)
        lease = ExecutorLease(self, ids)
        self._live_leases.add(lease)
        return lease

    def reclaim_leaks(self) -> int:
        """Recover executor ids leased out but claimed by no live lease
        (corrupt release, dropped lease object).  Returns the count."""
        expected: set[int] = set()
        for lease in list(self._live_leases):
            expected.update(lease.outstanding_ids)
        return self._admission.reclaim(expected)

    @property
    def leased_executors(self) -> int:
        """Executors currently out on leases (observability/tests)."""
        return (self.n_workers - self._admission.n_free
                - self._admission.n_quarantined)

    def health(self) -> dict:
        """Liveness counters a supervisor samples into heartbeats:
        quarantine or leak growth marks a degrading worker."""
        adm = self._admission
        return {
            "n_workers": self.n_workers,
            "free": adm.n_free,
            "waiting": adm.n_waiting,
            "quarantined": adm.n_quarantined,
            "bad_releases": adm.n_bad_releases,
            "leaks_reclaimed": adm.n_leaks_reclaimed,
            "shed": adm.n_shed,
            "stuck_close": len(self._pool.stuck_executors) if self._pool else 0,
        }

    # -- planning caches -----------------------------------------------------
    def cached(self, graph: Graph, key: tuple, build: Callable[[], Any]) -> Any:
        """Per-graph artifact cache (plans, host schedulers) the runtime
        mediates.

        ``key`` must encode everything the artifact depends on besides the
        graph itself (width, team size, policy, cost fingerprint).  The
        store rides on the graph object (cached plans/schedulers hold a
        strong reference to their graph, so any runtime-side map would pin
        the graph alive forever — this way a dropped graph frees its
        artifacts with it, and two executables over one graph share).
        Entries for a graph are dropped wholesale by :meth:`invalidate`
        (an executable re-profiled with new measured costs).
        """
        with self._cache_lock:
            per_graph = graph.__dict__.setdefault("_graphi_artifacts", {})
            hit = per_graph.get(key)
        if hit is not None:
            return hit
        made = build()
        with self._cache_lock:
            return per_graph.setdefault(key, made)

    def invalidate(self, graph: Graph) -> None:
        with self._cache_lock:
            graph.__dict__.pop("_graphi_artifacts", None)

    # -- compile -------------------------------------------------------------
    def compile(self, target: Any, *specs: Any, **kw: Any):
        """``repro_torch.compile`` bound to this runtime: the returned
        :class:`~repro_torch.api.Executable` executes on leases from this
        runtime's pool, seeds its cost model from the calibration store,
        and writes ``calibrate()`` results back to it."""
        from repro_torch import api

        kw.setdefault("hw", self.hw)
        kw.setdefault("reserved_workers", self.reserved_workers)
        return api.compile(target, *specs, runtime=self, **kw)

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Close the pool and persist the calibration store (idempotent).
        In-flight leases finish their queued work (pool close drains
        FIFO-before-sentinel); new leases and compiles raise."""
        if self._closed:
            return
        self._closed = True
        # persist calibration *before* joining executor threads: a stuck
        # executor must not cost the measured tables too
        if self.calibration.path is not None:
            self.calibration.save()
        if self._pool is not None:
            self._pool.close()

    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def describe(self) -> str:
        pin = self.pinning
        if self.pinning_applied is not None:
            pin += ":pinned" if self.pinning_applied.pinned else ":no-op"
        return (
            f"Runtime(n_workers={self.n_workers}, device={self.device}, hw={self.hw.name}, "
            f"pool={'live' if self._pool is not None else 'lazy'}, "
            f"leased={self.leased_executors}, pinning={pin}, "
            f"calibrations={len(self.calibration)})"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.describe()


# -- the process-wide default ------------------------------------------------
_defaults: dict[str, Runtime] = {}
_default_lock = threading.Lock()


def default_runtime(device: str | torch.device = "cuda") -> Runtime:
    """The process-wide :class:`Runtime` of a device type, behind bare
    ``repro_torch.compile`` (``"cuda"``) and engines built with
    ``device="cpu"``.

    Created on first use (device-sized pool, no calibration path); if the
    current default was closed, a fresh one replaces it.
    """
    dev = resolve_device(device)
    with _default_lock:
        rt = _defaults.get(dev.type)
        if rt is None or rt.closed:
            rt = _defaults[dev.type] = Runtime(device=dev)
        return rt


def set_default_runtime(rt: Runtime | None, device: str = "cuda") -> Runtime | None:
    """Swap the process default of a device type (tests, or an app that
    wants one configured runtime everywhere); returns the previous one (not
    closed)."""
    kind = torch.device(device).type
    with _default_lock:
        prev = _defaults.pop(kind, None)
        if rt is not None:
            _defaults[kind] = rt
        return prev
