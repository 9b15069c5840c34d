"""Schedulers for computation graphs (paper §4.3).

``make_schedule`` runs the online engine (noise-free) under a policy —
resolved by name through the :mod:`repro_torch.core.policies` registry, so CPF,
level-packing, LPT, perturbed CPF, and anything user-registered all flow
through the same entry point — and returns a :class:`Schedule`: per-op
(executor, start, end) plus the derived *slot* structure used by the static
plan compiler (slots = barrier-separated groups of mutually independent
ops, at most ``n_executors`` wide — the spatial-multiplexing unit on an
SPMD mesh, see DESIGN.md §2.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .cost_model import HardwareModel
from .graph import Graph, GraphValidationError
from .policies import NAIVE_POLICIES, SchedulePolicy, get_policy
from .simulate import SimConfig, SimResult, simulate

__all__ = ["Schedule", "make_schedule", "slot_assignment"]


@dataclass
class Schedule:
    graph_name: str
    policy: str
    n_executors: int
    team_size: int
    makespan: float
    # name -> (executor, start, end)
    placements: dict[str, tuple[int, float, float]]
    op_costs: dict[str, float] = field(repr=False, default_factory=dict)
    # the simulation seed the schedule was produced under: with the policy
    # name, enough to replay a randomized policy's exact schedule (the
    # searched-winner records in the format-2 calibration store)
    seed: int = 0

    def start_order(self) -> list[str]:
        return sorted(self.placements, key=lambda n: (self.placements[n][1], n))

    def by_executor(self, n_executors: int | None = None) -> list[list[str]]:
        """Per-executor op names in start order — the frozen placement view
        the static host plan compiler consumes.  ``n_executors`` folds the
        schedule onto fewer executors (``e % n``) when the pool a plan will
        run on is narrower than the scheduled config."""
        n = self.n_executors if n_executors is None else n_executors
        if n < 1:
            raise ValueError(f"need >= 1 executor, got {n}")
        out: list[list[str]] = [[] for _ in range(n)]
        for nm in self.start_order():
            out[self.placements[nm][0] % n].append(nm)
        return out

    def validate(self, graph: Graph) -> None:
        """Every dep finishes before its consumer starts; executors never
        overlap. Raises :class:`GraphValidationError` otherwise (a typed
        exception, not ``assert`` — validation must survive ``python -O``).
        ``repro_torch.checks.check_schedule`` is the finding-reporting superset."""
        eps = 1e-12
        for n, (_, start, _) in self.placements.items():
            for d in graph.predecessors(n):
                _, _, dend = self.placements[d]
                if dend > start + eps:
                    raise GraphValidationError(
                        f"{n} starts before dep {d} ends")
        per_exec: dict[int, list[tuple[float, float, str]]] = {}
        for n, (e, s, t) in self.placements.items():
            per_exec.setdefault(e, []).append((s, t, n))
        for e, iv in per_exec.items():
            iv.sort()
            for (_s0, t0, a), (s1, _t1, b) in zip(iv, iv[1:]):
                if t0 > s1 + eps:
                    raise GraphValidationError(
                        f"executor {e}: {a} and {b} overlap")


def make_schedule(
    graph: Graph,
    hw: HardwareModel,
    *,
    n_executors: int,
    team_size: int,
    policy: "str | SchedulePolicy" = "cpf",
    costs: dict[str, float] | None = None,
    seed: int = 0,
) -> Schedule:
    """Schedule ``graph`` under ``policy`` (a registry name or a
    :class:`~repro_torch.core.policies.SchedulePolicy` instance; the naive
    shared-queue baselines ``"fifo"``/``"random"`` pass through for
    comparison runs).  ``seed`` feeds randomized policies — (policy, seed)
    replays the identical schedule."""
    if not (isinstance(policy, str) and policy in NAIVE_POLICIES):
        policy = get_policy(policy)   # fail fast on unknown names
    cfg = SimConfig(
        n_executors=n_executors,
        team_size=team_size,
        policy=policy,
        # noise-free, zero dispatch cost: the pure scheduling decision
        cpf_push_cost=0.0,
        queue_base_cost=0.0,
        queue_contention_cost=0.0,
    )
    res: SimResult = simulate(graph, hw, cfg, costs=costs, seed=seed)
    placements = {e.op: (e.executor, e.start, e.end) for e in res.trace}
    return Schedule(
        graph_name=graph.name,
        policy=policy if isinstance(policy, str) else policy.name,
        n_executors=n_executors,
        team_size=team_size,
        makespan=res.makespan,
        placements=placements,
        op_costs=res.op_costs,
        seed=seed,
    )


def slot_assignment(graph: Graph, schedule: Schedule) -> list[list[str]]:
    """Barrier-slot structure for static (SPMD) execution.

    Ops are taken in schedule start order; each op lands in the earliest slot
    after all its deps' slots that still has a free executor lane. The result
    is a list of slots, each a list of <= n_executors mutually-independent op
    names — directly stackable along an 'executor' mesh axis.
    """
    slot_of: dict[str, int] = {}
    occupancy: list[int] = []
    slots: list[list[str]] = []
    for n in schedule.start_order():
        lo = 0
        for d in graph.predecessors(n):
            lo = max(lo, slot_of[d] + 1)
        s = lo
        while s < len(slots) and occupancy[s] >= schedule.n_executors:
            s += 1
        while s >= len(slots):
            slots.append([])
            occupancy.append(0)
        slots[s].append(n)
        occupancy[s] += 1
        slot_of[n] = s
    return slots
