"""Pin executor threads to core sets (paper §3.1: pinned executors reach up
to ~1.45x the FLOPS of OS-scheduled threads).

The plan/apply split mirrors the rest of the stack: :func:`plan_pinning`
turns a :class:`~repro_torch.hwperf.topology.CpuTopology` into a
:class:`PinningPlan` (executor -> disjoint CPU set, socket-aware, SMT
siblings kept together) and :func:`pin_pool` applies it to a live
:class:`~repro_torch.core.engine.ExecutorPool` via ``os.sched_setaffinity`` on
each worker thread's native id.  On a CUDA card every executor is a
stream fed by one host thread, so what this pins is each stream's launcher
thread: the kernels themselves run where the card puts them.

Everything degrades to an unpinned no-op — with **one** process-wide
warning, never a crash — where affinity is unsupported: non-Linux (no
``sched_setaffinity``), a restricted cpuset that rejects the mask, or the
``REPRO_HWPERF_NO_AFFINITY`` environment variable (the CI smoke leg that
simulates a platform without affinity).
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

from .topology import CpuTopology, detect_topology, disjoint_core_sets

__all__ = [
    "NO_AFFINITY_ENV",
    "AppliedPinning",
    "PinningPlan",
    "affinity_supported",
    "pin_current_thread",
    "pin_pool",
    "plan_pinning",
]

# set (to any non-empty value) to behave as if sched_setaffinity does not
# exist: the no-affinity smoke leg proves the whole stack degrades to
# unpinned execution instead of crashing
NO_AFFINITY_ENV = "REPRO_HWPERF_NO_AFFINITY"

_warned = False


def _warn_once(msg: str) -> None:
    """One warning per process: a serve loop re-leasing executors every step
    must not emit a warning per step on a platform that simply has no
    affinity syscall."""
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _reset_warning_for_tests() -> None:
    global _warned
    _warned = False


def affinity_supported() -> bool:
    """Whether thread pinning can work here at all: Linux-style
    ``sched_setaffinity`` present and not disabled via
    :data:`NO_AFFINITY_ENV`."""
    if os.environ.get(NO_AFFINITY_ENV):
        return False
    return hasattr(os, "sched_setaffinity") and hasattr(os, "sched_getaffinity")


@dataclass(frozen=True)
class PinningPlan:
    """Executor index -> CPU id set, plus the topology it was planned on."""

    assignments: tuple[tuple[int, ...], ...]
    topology: CpuTopology

    @property
    def n_executors(self) -> int:
        return len(self.assignments)

    @property
    def disjoint(self) -> bool:
        """Whether no CPU serves two executors (False only when the machine
        has fewer usable CPUs than executors)."""
        seen: set[int] = set()
        for cpus in self.assignments:
            if seen.intersection(cpus):
                return False
            seen.update(cpus)
        return True

    def cpus_for(self, executor: int) -> tuple[int, ...]:
        return self.assignments[executor % len(self.assignments)]

    def describe(self) -> str:
        sets = ", ".join(
            f"E{i}->[{','.join(map(str, c))}]"
            for i, c in enumerate(self.assignments))
        return (f"PinningPlan({self.n_executors} executors, "
                f"disjoint={self.disjoint}, {sets})")


def plan_pinning(
    n_executors: int,
    topology: CpuTopology | None = None,
    *,
    cpus_per_executor: int | None = None,
) -> PinningPlan:
    """Socket-aware executor->CPU-set assignment over ``topology``
    (detected from the running machine when not given)."""
    topo = topology if topology is not None else detect_topology()
    sets = disjoint_core_sets(topo, n_executors, cpus_per_set=cpus_per_executor)
    return PinningPlan(assignments=tuple(sets), topology=topo)


@dataclass
class AppliedPinning:
    """What actually happened when a plan met the OS."""

    plan: PinningPlan
    pinned: bool
    n_threads: int = 0
    errors: tuple[str, ...] = field(default_factory=tuple)

    def describe(self) -> str:
        state = "pinned" if self.pinned else "unpinned (no-op)"
        err = f", errors={list(self.errors)}" if self.errors else ""
        return f"AppliedPinning({state}, {self.n_threads} threads{err})"


def _set_affinity(tid: int, cpus: tuple[int, ...]) -> None:
    os.sched_setaffinity(tid, cpus)


def pin_current_thread(cpus: tuple[int, ...]) -> bool:
    """Pin the calling thread (the co-location harness's measurement
    threads); returns whether the pin took."""
    if not affinity_supported():
        _warn_once(
            "thread pinning unavailable on this platform "
            "(no sched_setaffinity); running unpinned")
        return False
    try:
        _set_affinity(0, cpus)   # tid 0 = the calling thread
        return True
    except OSError as e:
        _warn_once(
            f"thread pinning rejected by the OS ({e}); running unpinned")
        return False


def pin_pool(pool, plan: PinningPlan) -> AppliedPinning:
    """Pin each of ``pool``'s executor threads to its planned CPU set.

    Best-effort and all-or-nothing: if any pin is rejected (restricted
    cpuset, permissions) every already-pinned thread is restored to the
    full usable mask, one warning is emitted, and the pool runs unpinned —
    a half-pinned pool would concentrate every executor the OS *did* accept
    onto a fraction of the machine.
    """
    if not affinity_supported():
        _warn_once(
            "executor pinning unavailable on this platform "
            "(no sched_setaffinity); pool runs OS-scheduled")
        return AppliedPinning(plan=plan, pinned=False)
    tids = pool.executor_thread_ids()
    full_mask = tuple(sorted(c.cpu for c in plan.topology.cpus))
    pinned: list[int] = []
    for ex, tid in enumerate(tids):
        if tid is None:   # thread not started / already exited
            continue
        try:
            _set_affinity(tid, plan.cpus_for(ex))
            pinned.append(tid)
        except OSError as e:
            for done in pinned:
                try:
                    _set_affinity(done, full_mask)
                except OSError:  # pragma: no cover - rollback best-effort
                    pass
            _warn_once(
                f"executor pinning rejected by the OS ({e}); "
                "pool runs OS-scheduled")
            return AppliedPinning(plan=plan, pinned=False, errors=(str(e),))
    return AppliedPinning(plan=plan, pinned=bool(pinned), n_threads=len(pinned))
