"""Offline simulator-guided schedule search (ROADMAP: "beyond CPF").

The stack already owns everything a schedule *search* needs: a noise-free
discrete-event simulator (:mod:`repro_torch.core.simulate`), measured per-op
costs (``Executable.calibrate`` / the runtime's ``CalibrationStore``), and
static host plans that replay one frozen schedule per decode token.  So
instead of settling for critical-path-first, :func:`search_schedule` scores
**every registered policy** (:mod:`repro_torch.core.policies`) — randomized
policies over ``n_restarts`` seeds — in the simulator with the caller's
cost table (calibrated when available, analytic otherwise) and returns the
min-makespan winner.

The winner is verified against the ``repro_torch.checks`` schedule rules
(S-COVER/S-DEP/S-EXEC/S-OVERLAP) before it is returned: the static verifier
is the safety net that makes aggressive search cheap to trust — a policy
bug surfaces here as a typed error, never as a wedged host plan.

Candidate order is deterministic (CPF first, then registration order, then
seed), and the simulator breaks priority ties in stable node-id order, so
a (policy, seed) pair *names* a schedule: the persisted winner record
``{policy, seed, makespan_sim, runner_up_gap}`` replays bit-identically in
any later process (the format-2 ``CalibrationStore`` schedule sections).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from .cost_model import HardwareModel
from .graph import Graph
from .policies import SchedulePolicy, get_policy, list_policies
from .scheduler import Schedule, make_schedule

__all__ = ["CandidateScore", "SearchResult", "search_schedule", "DEFAULT_RESTARTS"]

# seeded restarts per randomized policy: enough draws to escape CPF's
# tie-break plateaus on small graphs while the whole search stays a few
# dozen noise-free simulations
DEFAULT_RESTARTS = 8


@dataclass(frozen=True)
class CandidateScore:
    policy: str
    seed: int
    makespan: float


@dataclass
class SearchResult:
    """The searched winner plus the full scoreboard."""

    policy: str                       # winning policy name
    seed: int                         # winning seed (0 for deterministic)
    makespan_sim: float               # winner's simulated makespan
    runner_up_gap: float              # (2nd best - best) / best, >= 0
    cpf_makespan: float               # the reference heuristic's score
    candidates: list[CandidateScore]  # every scored (policy, seed)
    schedule: Schedule                # the winning schedule itself

    @property
    def gain_over_cpf(self) -> float:
        """Fractional makespan reduction vs plain CPF (>= 0 by
        construction — CPF is always a candidate)."""
        if self.cpf_makespan <= 0.0:
            return 0.0
        return 1.0 - self.makespan_sim / self.cpf_makespan

    def record(self) -> dict:
        """The JSON-able winner record persisted per graph signature."""
        return {
            "policy": self.policy,
            "seed": self.seed,
            "makespan_sim": self.makespan_sim,
            "runner_up_gap": self.runner_up_gap,
        }

    def by_policy(self) -> dict[str, float]:
        """Best makespan per policy (benchmark reporting)."""
        out: dict[str, float] = {}
        for c in self.candidates:
            if c.policy not in out or c.makespan < out[c.policy]:
                out[c.policy] = c.makespan
        return out


def search_schedule(
    graph: Graph,
    hw: HardwareModel,
    *,
    n_executors: int,
    team_size: int,
    costs: Mapping[str, float] | None = None,
    policies: "Sequence[str | SchedulePolicy] | None" = None,
    n_restarts: int = DEFAULT_RESTARTS,
    base_seed: int = 0,
    verify: bool = True,
) -> SearchResult:
    """Score every candidate policy in the simulator; return the winner.

    ``costs`` is the per-op cost table the candidates are scored under —
    pass the calibrated (measured) table when one exists; ``None`` falls
    back to the analytic cost model at ``team_size``.  ``policies``
    restricts the candidate set (default: every registered policy, CPF
    first).  Randomized policies score ``n_restarts`` seeds starting at
    ``base_seed``.  Ties keep the earliest candidate, so CPF wins exact
    ties — search never trades the known-good heuristic for noise.

    ``verify=True`` runs the ``repro_torch.checks`` schedule invariants over the
    winner and raises on any error finding before the result escapes.
    """
    if n_restarts < 1:
        raise ValueError(f"need n_restarts >= 1, got {n_restarts}")
    pols = [get_policy(p) for p in (policies if policies is not None
                                    else list_policies())]
    if not pols:
        raise ValueError("search_schedule needs at least one policy")

    candidates: list[CandidateScore] = []
    best: Schedule | None = None
    cpf_makespan: float | None = None
    for pol in pols:
        seeds = (range(base_seed, base_seed + n_restarts)
                 if pol.randomized else (base_seed,))
        for seed in seeds:
            sched = make_schedule(
                graph, hw, n_executors=n_executors, team_size=team_size,
                policy=pol, costs=dict(costs) if costs is not None else None,
                seed=seed,
            )
            candidates.append(CandidateScore(pol.name, seed, sched.makespan))
            if pol.name == "cpf" and cpf_makespan is None:
                cpf_makespan = sched.makespan
            if best is None or sched.makespan < best.makespan:
                best = sched
    if best is None:  # unreachable: pols non-empty, n_restarts >= 1
        raise RuntimeError("schedule search scored no candidates")

    others = sorted(c.makespan for c in candidates)
    runner_up = others[1] if len(others) > 1 else best.makespan
    gap = ((runner_up - best.makespan) / best.makespan
           if best.makespan > 0 else 0.0)

    if verify:
        # the PR 7 verifier: a winner that violates coverage/dependency/
        # exclusivity invariants must never be persisted or frozen
        from repro_torch.checks import check_schedule

        check_schedule(best, graph).raise_if_errors()

    return SearchResult(
        policy=best.policy,
        seed=best.seed,
        makespan_sim=best.makespan,
        runner_up_gap=gap,
        cpf_makespan=(cpf_makespan if cpf_makespan is not None
                      else best.makespan),
        candidates=candidates,
        schedule=best,
    )
