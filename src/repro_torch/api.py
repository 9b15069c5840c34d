"""``graphi.compile()`` — one capture → profile → plan → execute API.

The paper's Fig-4 pipeline as an object model::

    import repro_torch
    exe = repro_torch.compile(fn, params, batch, hw=repro_torch.H100)
    exe.graph            # the captured OpNode DAG
    exe.profile          # best (n_executors, team_size) + per-op cost table
    exe.schedule         # frozen critical-path-first schedule
    exe.critical_path    # (length_s, [op, ...])
    out = exe(params, batch)   # dispatch through the chosen backend

``compile`` accepts either a PyTorch callable plus example inputs (captured
via ``core.capture``) or an already-built
:class:`~repro_torch.core.graph.Graph` (the paper nets).  All planning artifacts are lazy, cached properties;
``Executable`` is the one handle the rest of the stack (launch, train,
benchmarks, examples) talks to.

Every executable belongs to a :class:`repro_torch.runtime.Runtime` — the
process-wide session that owns the single executor pool, the persistent
calibration store, and the admission layer.  Bare ``repro_torch.compile(...)``
binds to :func:`repro_torch.runtime.default_runtime`; a host run leases its
calibrated executor width from the runtime for exactly the duration of the
run, so concurrent executables share the machine with bounded interference
instead of each spawning threads.  An explicit ``pool=`` bypasses admission
(the caller owns sharing).

Backends
--------
* ``"host"`` — the paper-faithful dynamic runtime (:class:`HostScheduler`):
  real execution on executor threads, returns ``fn``'s output pytree.
* ``"sim"``  — cost-model replay only; calling the executable returns the
  :class:`SimResult` (no numerics — the only callable backend for stat-only
  graphs such as the paper nets).

The JAX package's ``"mesh"`` backend (executor sub-meshes) is not ported
yet.
"""
from __future__ import annotations

import hashlib
from typing import Any, Mapping

import operator

import torch

from repro_torch.core.capture import CapturedGraph, capture
from repro_torch.core.cost_model import KNL7250, HardwareModel, sequential_makespan
from repro_torch.core.engine import (DeadlineExceeded, ExecutorPool, HostRunResult,
                                     HostScheduler)
from repro_torch.core.graph import Graph
from repro_torch.core.profiler import ProfileResult, measure_op_costs, profile, sync_cuda
from repro_torch.core.scheduler import Schedule, make_schedule, slot_assignment
from repro_torch.core.search import SearchResult, search_schedule
from repro_torch.core.simulate import SimConfig, SimResult, simulate
from repro_torch.core.static_host import StaticHostPlan, compile_host_plan
from repro_torch.runtime import Runtime, default_runtime, graph_signature

__all__ = ["Executable", "compile", "serve_engine"]


def _cost_fp(costs: Mapping[str, float] | None) -> str | None:
    """Content fingerprint of a cost table (two executables over one graph
    share plans only when their cost models agree).  A *stable* sha over
    sorted items — not ``hash(frozenset)`` — because the fingerprint is also
    part of the persisted schedule-search config key, which must mean the
    same thing across processes (``PYTHONHASHSEED`` varies ``hash``)."""
    if costs is None:
        return None
    h = hashlib.sha256()
    for k in sorted(costs):
        h.update(f"{k}:{float(costs[k])!r};".encode())
    return h.hexdigest()[:16]

_BACKENDS = ("host", "sim")
_HOST_MODES = ("dynamic", "static")
_CHECK_MODES = ("off", "basic", "strict")
_SEARCH_MODES = ("off", "auto", "force")


class Executable:
    """A scheduled computation graph: callable, introspectable, lazy.

    Planning artifacts (``profile`` → ``schedule`` → ``slots``) are computed
    on first access and cached; mutating knobs after first use is not
    supported — recompile instead.
    """

    def __init__(
        self,
        graph: Graph,
        hw: HardwareModel,
        *,
        captured: CapturedGraph | None = None,
        backend: str = "host",
        policy: str = "cpf",
        n_workers: int | None = None,
        reserved_workers: int = 2,
        n_executors: int | None = None,
        team_size: int | None = None,
        pool: ExecutorPool | None = None,
        host_mode: str = "dynamic",
        runtime: Runtime | None = None,
        signature: str | None = None,
        check: str = "basic",
        schedule_search: str = "auto",
    ):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if host_mode not in _HOST_MODES:
            raise ValueError(
                f"host_mode must be one of {_HOST_MODES}, got {host_mode!r}")
        if check not in _CHECK_MODES:
            raise ValueError(
                f"check must be one of {_CHECK_MODES}, got {check!r}")
        if schedule_search not in _SEARCH_MODES:
            raise ValueError(
                f"schedule_search must be one of {_SEARCH_MODES}, "
                f"got {schedule_search!r}")
        if check != "off":
            # structural graph verification (repro_torch.checks G-* rules):
            # O(V+E), runs once per executable — a malformed graph fails
            # loudly here, not as a stuck run or a wrong plan deep in the
            # host runtime
            from repro_torch.checks import check_graph

            check_graph(graph).raise_if_errors()
        self.check = check
        self._graph = graph
        self.hw = hw
        self.captured = captured
        self.backend = backend
        self.policy = policy
        self.n_workers = n_workers
        self.reserved_workers = reserved_workers
        self._pin = (n_executors, team_size)
        self.pool = pool
        self.host_mode = host_mode
        self.runtime = runtime
        self.signature = signature
        self.schedule_search = schedule_search
        self._search: SearchResult | None = None   # last search this exe ran
        self._search_hit: dict | None = None       # last store-replayed record
        self._host: HostScheduler | None = None
        self._host_key: tuple | None = None
        self._host_plans: dict[int, StaticHostPlan] = {}
        self._lease_ids: tuple[int, ...] = ()   # sticky-lease affinity hint
        self._measured: Any = None   # measured_costs fn from the last profile
        self._planned: int | None = None   # cached default executor count
        self._n_real: int | None = None    # cached non-input node count
        self._profile: ProfileResult | None = None
        self._schedule: Schedule | None = None
        self._slots: list[list[str]] | None = None
        self.last_run: HostRunResult | SimResult | None = None

    # -- introspection (the .lower()-style surface) -------------------------
    @property
    def graph(self) -> Graph:
        return self._graph

    @property
    def usable_workers(self) -> int:
        n = self.n_workers if self.n_workers is not None else self.hw.n_workers
        return max(1, n - self.reserved_workers)

    @property
    def profile(self) -> ProfileResult:
        if self._profile is None:
            kw: dict[str, Any] = {}
            if self._measured is not None:
                # seeded from the runtime's calibration store (or a prior
                # calibrate): the lazy first profile must use the measured
                # table too, not silently fall back to analytic costs
                kw["measured_costs"] = self._measured
            self._profile = profile(
                self._graph, self.hw, n_workers=self.usable_workers,
                policy=self.policy, **kw
            )
        return self._profile

    def profile_with(self, **kw: Any) -> ProfileResult:
        """Re-run the configuration search with profiler kwargs
        (``extra_configs=``, ``measured_costs=``, ...) and cache the result.

        ``measured_costs`` sticks: subsequent schedules (and the static
        host plans frozen from them) — and later ``profile_with`` calls —
        use the measured table instead of the analytic cost model, so the
        config search and the frozen placements always agree on one cost
        model.  Pass ``measured_costs=None`` to revert."""
        if "measured_costs" in kw:
            self._measured = kw["measured_costs"]
        elif self._measured is not None:
            kw = {**kw, "measured_costs": self._measured}
        self._profile = profile(
            self._graph, self.hw, n_workers=self.usable_workers, policy=self.policy, **kw
        )
        self._schedule = None
        self._slots = None
        self._host = None           # dynamic CPF priorities follow the costs
        self._host_key = None
        self._host_plans.clear()    # plans froze the invalidated schedule
        self._planned = None        # best executor count may have moved
        self._search = None         # a searched winner is per cost model
        self._search_hit = None
        if self.runtime is not None:
            self.runtime.invalidate(self._graph)
        return self._profile

    @property
    def schedule(self) -> Schedule:
        if self._schedule is None:
            n_exec, team = self._pin
            if n_exec is None or team is None:
                p = self.profile
                n_exec = n_exec or p.best_n_executors
                team = team or p.best_team_size
            self._schedule = self._plan_schedule(n_exec, team)
        return self._schedule

    def schedule_for(self, policy: str) -> Schedule:
        """A schedule under an *explicit* policy (registry name or naive
        baseline) at the profiled config — comparison runs; never searched."""
        n_exec, team = self._pin
        if n_exec is None or team is None:
            p = self.profile
            n_exec = n_exec or p.best_n_executors
            team = team or p.best_team_size
        costs = dict(self._measured(team)) if self._measured is not None else None
        return make_schedule(
            self._graph, self.hw, n_executors=n_exec, team_size=team,
            policy=policy, costs=costs,
        )

    @property
    def search_active(self) -> bool:
        """Whether schedule planning runs the simulator-guided policy search
        (:mod:`repro_torch.core.search`).  ``"force"`` always searches; ``"auto"``
        (the default) searches once a *measured* cost table backs the
        executable — searching on analytic costs would optimize the model,
        not the machine — and only for the default CPF policy (an explicit
        ``policy=`` pin means the caller chose their heuristic)."""
        if self.schedule_search == "off":
            return False
        if self.schedule_search == "force":
            return True
        return self._measured is not None and self.policy == "cpf"

    def _config_key(self, n_exec: int, team: int,
                    costs: Mapping[str, float] | None) -> str:
        """The per-signature store key a searched winner persists under:
        executor config x cost-model fingerprint (search once per graph,
        width, and cost table — across processes)."""
        return f"{n_exec}x{team}|{_cost_fp(costs) or 'analytic'}"

    def _plan_schedule(self, n_exec: int, team: int) -> Schedule:
        """The schedule the executable freezes at config (n_exec, team):
        plain ``self.policy`` when search is off, else the searched winner —
        replayed from the runtime store when this (graph signature, config,
        cost model) was already searched, run (and persisted) otherwise."""
        costs = dict(self._measured(team)) if self._measured is not None else None
        if not self.search_active:
            return make_schedule(
                self._graph, self.hw, n_executors=n_exec, team_size=team,
                policy=self.policy, costs=costs,
            )
        store = (self.runtime.calibration
                 if self.runtime is not None and self.signature is not None
                 else None)
        ck = self._config_key(n_exec, team, costs)
        if store is not None:
            rec = store.get_schedule(self.signature, ck)
            if rec is not None:
                try:
                    sched = make_schedule(
                        self._graph, self.hw, n_executors=n_exec,
                        team_size=team, policy=rec["policy"],
                        seed=int(rec.get("seed", 0)), costs=costs,
                    )
                except (ValueError, KeyError):
                    # record names a policy this build doesn't register —
                    # fall through and search again rather than fail compile
                    pass
                else:
                    self._search_hit = dict(rec)
                    return sched
        # module-level entry point on purpose: tests monkeypatch
        # repro_torch.api.search_schedule to prove a second compile()
        # replays the stored winner without re-searching
        res = search_schedule(
            self._graph, self.hw, n_executors=n_exec, team_size=team,
            costs=costs,
        )
        self._search = res
        self._search_hit = None
        if store is not None:
            # search_schedule already verified the winner against the
            # repro_torch.checks S-rules — only vetted schedules are persisted
            store.put_schedule(self.signature, ck, res.record())
        return res.schedule

    @property
    def slots(self) -> list[list[str]]:
        """Barrier-slot structure of the frozen schedule (static plan)."""
        if self._slots is None:
            self._slots = slot_assignment(self._graph, self.schedule)
        return self._slots

    @property
    def critical_path(self) -> tuple[float, list[str]]:
        return self._graph.critical_path(self.schedule.op_costs)

    def calibrate(
        self,
        *args: Any,
        inputs: Mapping[str, Any] | None = None,
        warmup: int = 1,
        iters: int = 3,
        max_executors: int | None = None,
    ) -> ProfileResult:
        """Profile-guided replanning: time every node ``fn`` on concrete
        values (the paper's first-iterations profiling) and re-run the
        configuration search with the measured table.  Subsequent schedules
        — and the static host plans frozen from them — place ops by how
        long they *actually* take, not by the analytic cost model, which
        misranks tiny jitted ops whose cost is dispatch, not flops.

        Pass the executable's call args (captured graphs) or a name→value
        mapping via ``inputs``.  Node fns should be warm (run the
        executable once first) so compile time is not measured.

        When the executable belongs to a :class:`~repro_torch.runtime.Runtime`,
        the measured table is written to the runtime's
        :class:`~repro_torch.runtime.CalibrationStore` under the graph's
        signature — a later ``compile`` of the same graph (this process or,
        with a store path, the next one) starts calibrated without
        re-measuring.  CUDA ops are timed with the device synchronised
        around each call.
        """
        if args:
            if self.captured is None:
                raise TypeError("calibrate(*args) needs a captured graph; "
                                "pass inputs= for raw graphs")
            inputs = self.captured.bind(args)
        costs = measure_op_costs(
            self._graph, inputs, warmup=warmup, iters=iters,
            block=sync_cuda,
        )
        if self.runtime is not None and self.signature is not None:
            self.runtime.calibration.put(self.signature, costs)
        kw: dict[str, Any] = {"measured_costs": lambda _team: costs}
        if max_executors is not None:
            kw["max_executors"] = max_executors
        return self.profile_with(**kw)

    @property
    def calibrated(self) -> bool:
        """Whether a measured cost table backs this executable's schedules
        (from :meth:`calibrate` or seeded from the runtime's store)."""
        return self._measured is not None

    def simulate(self, **kw: Any) -> SimResult:
        p = self.profile
        cfg = SimConfig(
            n_executors=kw.pop("n_executors", self._pin[0] or p.best_n_executors),
            team_size=kw.pop("team_size", self._pin[1] or p.best_team_size),
            policy=kw.pop("policy", self.policy),
            **kw,
        )
        return simulate(self._graph, self.hw, cfg, costs=p.op_costs)

    def verify(self, *, plan: bool = True):
        """Run the structural verifier over this executable's artifacts.

        Returns the :class:`repro_torch.checks.Report`: graph structural
        rules, schedule feasibility, and compiled host-plan invariants
        (``plan=True`` builds/fetches the default :meth:`host_plan`).
        Raises nothing itself; gate on ``report.ok`` or call
        ``report.raise_if_errors()``.  (The JAX package's buffer-hazard
        analysis reads jaxpr equations and is not ported yet.)
        """
        from repro_torch.checks import check_graph, check_plan, check_schedule

        rep = check_graph(self._graph)
        rep.extend(check_schedule(self.schedule, self._graph))
        if plan:
            rep.extend(check_plan(self.host_plan(), self._graph))
        return rep

    def describe(self, *, trace: bool | str = False) -> str:
        """One-paragraph summary of the executable; with ``trace`` a
        per-executor timeline is appended (paper §5.2's visualization).

        ``trace=True`` renders an ASCII timeline, ``trace="csv"`` the CSV
        table (:mod:`repro_torch.core.trace`).  The timeline shows the **last
        run** when one exists (measured, host or sim backend) and falls
        back to a fresh cost-model simulation otherwise — the source is
        labeled, so measured-vs-simulated timelines are distinguishable.
        """
        g = self._graph
        sched = self.schedule
        cp_len, cp = self.critical_path
        seq = sequential_makespan(self.hw, g, sched.team_size)
        if self._search is not None:
            r = self._search
            search_line = (
                f"\n  schedule search: winner={r.policy!r} seed={r.seed} "
                f"makespan_sim={r.makespan_sim:.3e}s "
                f"gain_over_cpf={100.0 * r.gain_over_cpf:.2f}% "
                f"runner_up_gap={100.0 * r.runner_up_gap:.2f}%"
            )
        elif self._search_hit is not None:
            r = self._search_hit
            search_line = (
                f"\n  schedule search: winner={r['policy']!r} "
                f"seed={r.get('seed', 0)} "
                f"makespan_sim={r['makespan_sim']:.3e}s (replayed from store)"
            )
        else:
            search_line = ""
        text = (
            f"Executable({g.name!r}, backend={self.backend!r}, hw={self.hw.name})\n"
            f"  nodes={len(g)} width={g.width()} flops={g.total_flops():.3g}\n"
            f"  config: {sched.n_executors} executors x {sched.team_size} workers "
            f"({sched.policy})\n"
            f"  makespan={sched.makespan:.3e}s sequential={seq:.3e}s "
            f"speedup={seq / sched.makespan if sched.makespan else 0.0:.2f}x\n"
            f"  critical path ({cp_len:.3e}s, {len(cp)} ops): "
            f"{' -> '.join(cp[:6])}{' ...' if len(cp) > 6 else ''}"
            f"{search_line}"
        )
        if trace:
            text += "\n" + self.render_trace(
                fmt="csv" if trace == "csv" else "ascii")
        return text

    def render_trace(self, *, fmt: str = "ascii") -> str:
        """The per-executor execution timeline: the last run's measured
        trace when one exists, else a fresh cost-model simulation.
        ``fmt="ascii"`` or ``"csv"`` (:mod:`repro_torch.core.trace`)."""
        from repro_torch.core.trace import ascii_timeline, trace_csv

        run = self.last_run
        if run is not None and getattr(run, "trace", None):
            source = ("simulated" if isinstance(run, SimResult)
                      else "measured")
        else:
            run = self.simulate()
            source = "simulated"
        n = (run.config.n_executors if isinstance(run, SimResult)
             else 1 + max((e.executor for e in run.trace), default=0))
        if fmt == "csv":
            return trace_csv(run.trace)
        if fmt != "ascii":
            raise ValueError(f"fmt must be 'ascii' or 'csv', got {fmt!r}")
        return (f"trace ({source}, {len(run.trace)} ops):\n"
                + ascii_timeline(run.trace, n))

    # -- execution ----------------------------------------------------------
    def _host_executors(self, n_executors: int | None = None) -> int:
        explicit = n_executors if n_executors is not None else self._pin[0]
        if explicit is None and self._planned is not None:
            return self._planned    # O(1) on the per-step decode hot path
        if self._n_real is None:
            # input passthroughs resolve inline in the scheduler — only
            # real ops occupy executor threads
            self._n_real = sum(
                1 for nd in self._graph.nodes if nd.kind != "input")
        if explicit is not None:
            n = explicit
        else:
            n = self.profile.best_n_executors
            # the modelled best config may be one wide executor (team-size
            # trade-off); executor *threads* have no team dimension, so the
            # profiled default always exploits available DAG width — an
            # explicitly requested count is honored as-is
            if self._graph.width() >= 2:
                n = max(n, 2)
        n = min(n, max(1, self._n_real))
        if explicit is None:
            self._planned = n
        return n

    @property
    def planned_executors(self) -> int:
        """Executor-thread count the host backend will actually use."""
        return self._host_executors()

    def host_plan(self, n_executors: int | None = None) -> StaticHostPlan:
        """The compiled static host plan, cached per (graph, n_executors).

        Freezes the CPF schedule into per-executor integer-id programs
        (``core.static_host``); when the requested width differs from the
        cached schedule's config, a schedule is made for exactly that width
        (same policy and team size) rather than folding executors.  The
        default width is the *planned* executor count, capped at the bound
        pool's (or the runtime's) size — never widened to fill a larger
        shared pool: a plan frozen wider than the profiled config pays
        cross-executor wakeups the calibration chose to avoid.

        Plans live in the runtime's per-graph cache when the executable has
        one (two executables over one graph freeze placements once); a
        runtime-less executable keeps a local cache.
        """
        if n_executors is None:
            n_executors = self._host_executors()
            if self.pool is not None:
                n_executors = min(n_executors, self.pool.n_executors)
            elif self.runtime is not None:
                n_executors = min(n_executors, self.runtime.n_workers)

        def build() -> StaticHostPlan:
            sched = self.schedule
            if sched.n_executors != n_executors:
                # re-plan at exactly the requested width — through the same
                # search-or-policy path as the default schedule, so a
                # searched executable freezes searched placements at every
                # width it runs at
                sched = self._plan_schedule(n_executors, sched.team_size)
            plan = compile_host_plan(self._graph, sched, n_executors=n_executors)
            if self.check == "strict":
                # verify every freshly-built plan (repro_torch.checks S-*/P-*
                # rules); cached fetches stay O(1) — the artifact is frozen,
                # re-verifying the same plan per step would buy nothing
                from repro_torch.checks import check_plan, check_schedule

                rep = check_schedule(sched, self._graph)
                rep.extend(check_plan(plan, self._graph))
                rep.raise_if_errors()
            return plan

        plan = self._host_plans.get(n_executors)
        if plan is not None:                 # O(1) on the per-step hot path
            return plan
        if self.runtime is not None:
            sched = self.schedule
            # keyed by the *frozen schedule's* identity (policy, seed) — a
            # searched executable must not collide with a plain-CPF one over
            # the same graph — plus the search mode, since at a different
            # width build() re-plans through search-or-policy again
            key = ("plan", n_executors, sched.team_size, sched.policy,
                   sched.seed, self.search_active,
                   _cost_fp(sched.op_costs or None))
            plan = self.runtime.cached(self._graph, key, build)
        else:
            plan = build()
        self._host_plans[n_executors] = plan
        return plan

    def _host_scheduler(self, n: int) -> HostScheduler:
        """The dynamic scheduler for width ``n`` (pool passed per run, so one
        scheduler serves every lease).  The runtime cache shares schedulers
        across executables of one graph; the exe-level slot in front of it
        keeps the per-step lookup O(1)."""
        if self._host is not None and self._host_key == (n,):
            return self._host

        def build() -> HostScheduler:
            return HostScheduler(
                self._graph, n, costs=self.schedule.op_costs or None)

        if self.runtime is not None:
            key = ("host", n, _cost_fp(self.schedule.op_costs or None))
            host = self.runtime.cached(self._graph, key, build)
        else:
            host = build()
        self._host = host
        self._host_key = (n,)
        return host

    def execute_host(
        self,
        inputs: Mapping[str, Any] | None = None,
        n_executors: int | None = None,
        pool: Any = None,
        *,
        host_mode: str | None = None,
        plan: StaticHostPlan | None = None,
        collect_trace: bool = False,
        deadline: float | None = None,
    ) -> HostRunResult:
        """Run the host runtime on a name→value input mapping.

        With a ``pool`` (given here or at compile time) the run submits to
        those persistent executors — the caller owns sharing — and the
        pool's size wins over the planned executor count.  Without one, the
        run **leases** its executor width from the executable's
        :class:`~repro_torch.runtime.Runtime` (the process default if none was
        bound) for exactly the duration of the run: concurrent executables
        queue for disjoint executor subsets instead of oversubscribing the
        machine.

        ``host_mode`` overrides the compile-time knob for this run:
        ``"static"`` executes the cached :meth:`host_plan` (lock-free
        dependency counters, no per-op scheduler round-trip) and is the
        right mode for a graph replayed many times; ``"dynamic"`` is the
        paper-faithful centralized scheduler.  An explicit ``plan`` forces
        static execution of exactly that plan.  ``collect_trace`` turns on
        per-op timestamps for static runs (dynamic runs always trace).

        ``deadline`` (absolute, ``time.monotonic``) bounds the whole run —
        the lease wait *and* execution.  On expiry the run raises
        :class:`~repro_torch.core.engine.DeadlineExceeded` and its lease is
        released with the still-busy executors **quarantined** (their
        threads are stuck inside the abandoned op; admission returns them
        to service when the op finally finishes) so a hung op degrades
        capacity instead of wedging the pool.
        """
        pool = pool if pool is not None else self.pool
        mode = host_mode if host_mode is not None else self.host_mode
        if mode not in _HOST_MODES:
            raise ValueError(
                f"host_mode must be one of {_HOST_MODES}, got {mode!r}")
        rt: Runtime | None = None
        if pool is None:
            rt = self.runtime
            if rt is None:
                # a bare Executable still shares the process pool — nothing
                # in the stack owns private executor threads any more
                rt = self.runtime = default_runtime()
        lease = None
        try:
            if plan is not None or mode == "static":
                if plan is None:
                    n = self._host_executors(n_executors)
                    if pool is not None:
                        n = min(n, pool.n_executors)
                    else:
                        n = min(n, rt.n_workers)
                    plan = self.host_plan(n)
                if pool is None:
                    if plan.n_executors > rt.n_workers:
                        # admission clamps leases to the pool — an oversized
                        # explicit plan must fail here, naming the remedy,
                        # not deep in plan.run after a silent clamp
                        raise ValueError(
                            f"plan needs {plan.n_executors} executors but the "
                            f"runtime has {rt.n_workers}; recompile the plan "
                            "for the runtime width or pass an explicit pool"
                        )
                    lease = rt.lease(plan.n_executors, prefer=self._lease_ids,
                                     deadline=deadline)
                    self._lease_ids = lease.executor_ids
                    pool = lease
                res = plan.run(inputs, pool=pool, collect_trace=collect_trace,
                               deadline=deadline)
                self.last_run = res
                return res
            n = self._host_executors(n_executors)
            if pool is not None:
                n = pool.n_executors
            else:
                n = min(n, rt.n_workers)
            host = self._host_scheduler(n)
            if pool is None:
                lease = rt.lease(n, prefer=self._lease_ids, deadline=deadline)
                self._lease_ids = lease.executor_ids
                pool = lease
            res = host.run(inputs, pool=pool, deadline=deadline)
            self.last_run = res
            return res
        except DeadlineExceeded:
            if lease is not None:
                # the abandoned op still owns its executor thread: releasing
                # it into the free set would hand the next run a busy
                # executor — quarantine it until the op finally returns
                lease.release(quarantine_busy=True)
                lease = None
            raise
        finally:
            if lease is not None:
                lease.release()

    def close(self) -> None:
        """Back-compat no-op: executables no longer own executor threads.
        Runs lease executors from the runtime and return them when the run
        completes; the pool itself is the runtime's to close."""

    def __enter__(self) -> "Executable":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __call__(self, *args: Any) -> Any:
        if self.backend == "sim":
            self.last_run = self.simulate()
            return self.last_run
        if self.captured is None:
            # raw-graph executables take a single name→value mapping
            inputs: Mapping[str, Any] | None = args[0] if args else None
        else:
            inputs = self.captured.bind(args)
        results = self.execute_host(inputs).outputs
        if self.captured is None:
            return results
        return self.captured.unflatten(results)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Executable({self._graph.name!r}, backend={self.backend!r}, "
            f"hw={self.hw.name}, n={len(self._graph)})"
        )


def compile(
    target: Any,
    *specs: Any,
    hw: HardwareModel = KNL7250,
    backend: str = "host",
    name: str | None = None,
    policy: str = "cpf",
    n_workers: int | None = None,
    reserved_workers: int = 2,
    n_executors: int | None = None,
    team_size: int | None = None,
    fuse: bool = True,
    jit_nodes: bool = False,
    pool: ExecutorPool | None = None,
    host_mode: str = "dynamic",
    runtime: Runtime | None = None,
    check: str = "basic",
    schedule_search: str = "auto",
    pinning: str | None = None,
) -> Executable:
    """Turn a PyTorch function (or a pre-built :class:`Graph`) into a
    scheduled :class:`Executable`.

    ``specs`` are the function's example inputs — pytrees of tensors
    (capture reads shapes, dtypes and devices only).
    ``n_executors``/``team_size`` pin the executor configuration instead of
    profiling for the best one.  ``runtime`` binds the executable to a
    :class:`~repro_torch.runtime.Runtime` session (defaulting to the process-wide
    one): host runs lease executors from its pool, planning artifacts land
    in its caches, and a calibration-store hit seeds the cost model without
    re-measuring.  ``pool`` instead shares one explicit persistent
    :class:`ExecutorPool` across executables, bypassing admission (e.g. a
    serve engine's prefill and decode graphs submitting to the same
    executors).  ``jit_nodes`` turns every node's group of aten ops into
    one generated ``torch.fx.GraphModule`` (straight-line Python code
    instead of the per-op interpreter loop), the right trade for graphs
    executed thousands of times (a serving decode loop).  ``host_mode``
    picks the host-backend runtime: ``"dynamic"`` (paper-faithful
    centralized scheduler) or ``"static"`` (compiled
    :class:`~repro_torch.core.static_host.StaticHostPlan` — per-op scheduling
    overhead amortized to ~zero, the right mode for replayed graphs).
    ``check`` picks the static-verification level (``repro_torch.checks``):
    ``"off"`` — none; ``"basic"`` (default) — O(V+E) graph structural rules
    at compile time; ``"strict"`` — additionally verify every freshly built
    host plan (schedule feasibility + plan invariants) before it runs.
    ``schedule_search`` controls the simulator-guided policy search
    (:mod:`repro_torch.core.search`): ``"auto"`` (default) searches every
    registered policy for the min-makespan schedule once a *measured* cost
    table backs the executable (``calibrate()`` or a calibration-store
    hit); ``"force"`` searches even on analytic costs; ``"off"`` always
    schedules with ``policy``.  Winners persist in the runtime's store per
    graph signature, so the search runs once per (graph, executor config,
    cost model) across processes.
    ``pinning`` sets the bound runtime's executor-thread core pinning
    (only ``"off"`` so far); ``None`` leaves the runtime's current mode
    alone.
    """
    captured: CapturedGraph | None = None
    if isinstance(target, CapturedGraph):
        if specs:
            raise TypeError("compile(captured_graph) takes no input specs "
                            "(they were fixed at capture time)")
        captured, graph = target, target.graph
    elif isinstance(target, Graph):
        if specs:
            raise TypeError("compile(graph) takes no input specs")
        graph = target
    else:
        captured = capture(target, *specs, name=name, fuse=fuse)
        graph = captured.graph
    if jit_nodes:
        if captured is None:
            raise TypeError("jit_nodes=True needs a captured function")
        graph = _fx_graph(graph)
    if runtime is None and pool is None:
        runtime = default_runtime()
    if pinning is not None and runtime is not None:
        runtime.set_pinning(pinning)
    signature = graph_signature(graph, variant="fx" if jit_nodes else "")
    exe = Executable(
        graph,
        hw,
        captured=captured,
        backend=backend,
        policy=policy,
        n_workers=n_workers,
        reserved_workers=reserved_workers,
        n_executors=n_executors,
        team_size=team_size,
        pool=pool,
        host_mode=host_mode,
        runtime=runtime,
        signature=signature,
        check=check,
        schedule_search=schedule_search,
    )
    if runtime is not None:
        costs = runtime.calibration.get(signature)
        if costs is not None:
            # a prior calibrate() of this graph (this process or a saved
            # store): schedules and plans start from measured costs
            exe._measured = lambda _team, _costs=costs: _costs
    return exe


def _group_module(node) -> torch.fx.GraphModule:
    """One captured node's group of aten ops as a generated GraphModule:
    its forward takes the dep values in ``deps`` order and returns the
    exports (one value, or a tuple) — the node ``fn`` without the
    interpreter loop."""
    meta = node.meta
    g = torch.fx.Graph()
    env: dict[Any, Any] = {}
    deps = [g.placeholder(f"dep{i}") for i in range(len(node.deps))]
    for src, dep_idx, slot, n_slots in meta["_imports"]:
        env[src] = (deps[dep_idx] if n_slots == 1
                    else g.call_function(operator.getitem, (deps[dep_idx], slot)))
    for src in meta["_consts"]:
        env[src] = g.get_attr(src.target)
    for m in meta["_fx_nodes"]:
        env[m] = g.node_copy(m, env.__getitem__)
    outs = [env[v] for v in meta["_exports"]]
    g.output(outs[0] if len(outs) == 1 else tuple(outs))
    root = {src.target: val for src, val in meta["_consts"].items()}
    return torch.fx.GraphModule(root, g, class_name=node.name.replace(".", "_"))


def _fx_graph(graph: Graph) -> Graph:
    """A copy of a captured ``graph`` whose node fns are generated
    GraphModules (the counterpart of the JAX package's ``jax.jit`` per
    node; not ``torch.compile``).

    A copy, not an in-place rewrite: callers may hand ``compile`` a graph
    they still execute directly (the capture oracle, parity tests).
    """
    from dataclasses import replace

    out = Graph(graph.name)
    for name in graph.names:
        node = graph[name]
        fn = _group_module(node) if node.fn is not None else None
        out.add(replace(node, fn=fn))
    return out


def serve_engine(
    cfg: Any,
    params: Any,
    serve_cfg: Any = None,
    *,
    continuous: bool = True,
    paged: Any = False,
    device: str | torch.device = "cuda",
    **kw: Any,
) -> Any:
    """Serve-shaped entry point: a serving engine over ``repro_torch.compile``,
    on the card unless ``device="cpu"``.

    ``continuous=True`` (default) returns the
    :class:`~repro_torch.serve.engine.ContinuousEngine` — prefill and decode
    captured as Graphi executables, a profiler-chosen executor config, and
    per-request slot admission.  ``continuous=False`` returns the
    length-bucketed wave :class:`~repro_torch.serve.engine.ServeEngine`.
    ``paged=True`` (or a :class:`~repro_torch.serve.paged.PagedConfig`)
    returns the :class:`~repro_torch.serve.paged.PagedEngine` instead —
    block-paged KV with prefix sharing and chunked prefill.  On the card
    prefill attention runs kernel B3, dense decode attention kernel B2 and
    paged decode attention kernel B1.  Extra kwargs go to the engine
    constructor — ``rng_seed=`` for any engine; ``hw=``,
    ``max_executors=``, ``pool=``, ``runtime=``, ``decode_host_mode=`` and
    ``schedule_search=`` are continuous/paged-only.
    """
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig, ServeEngine
    from repro_torch.serve.paged import PagedConfig, PagedEngine

    dev = resolve_device(device)
    scfg = serve_cfg if serve_cfg is not None else ServeConfig()
    if paged:
        pcfg = paged if isinstance(paged, PagedConfig) else None
        return PagedEngine(cfg, params, scfg, paged=pcfg, device=dev, **kw)
    eng_cls = ContinuousEngine if continuous else ServeEngine
    return eng_cls(cfg, params, scfg, device=dev, **kw)
