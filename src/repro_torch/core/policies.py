"""Pluggable scheduling policies: the priority layer of the Graphi engine.

The paper fixes one heuristic — critical-path-first (§4.3) — but no single
list-scheduling priority dominates across graph shapes (Mayer et al., "It's
the Critical Path!", PAPERS.md).  This module makes the policy a first-class
registry entry so the simulator, the scheduler, and the offline schedule
search (:mod:`repro_torch.core.search`) all resolve policies by *name* through one
table, and adding a policy is a one-file change.

A policy is two things:

* a **priority function** — a static per-node score; among *ready* ops the
  highest-priority one is dispatched first (ties break in stable node-id
  order, i.e. graph insertion index, so every policy's schedule is
  bit-reproducible run to run);
* an optional **executor-assignment hook** — given the executors that are
  free earliest, steer the op onto a specific one (Opara-style stream
  packing: align an op with its wave position so producer→consumer chains
  stay on one executor).  Returning ``None`` keeps the engine's default
  earliest-free placement.

Registered policies (all run on the CPF dispatch path — centralized
scheduler, per-executor buffers; the *naive shared-queue* baselines
``"fifo"``/``"random"`` model a different scheduler architecture and live in
:mod:`repro_torch.core.simulate`):

* ``cpf``          — the paper's critical-path-first: priority = *level*
  (longest accumulated cost from the op to the sink, §4.3).
* ``level-pack``   — pack ASAP waves in order (earlier wavefront first),
  with the stream-packing assignment hook.
* ``lpt``          — longest-processing-time: biggest ready op first (the
  classic makespan bound for independent tasks; wins when the DAG is wide
  and costs are skewed).
* ``cpf-perturb``  — CPF with seeded multiplicative priority noise; the
  search runs N restarts and keeps the best draw (randomized restarts
  escape CPF's tie-breaking plateaus).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Mapping, Protocol, runtime_checkable

from .graph import Graph

__all__ = [
    "PolicyContext",
    "SchedulePolicy",
    "CriticalPathFirst",
    "LevelPack",
    "LongestProcessingTime",
    "PerturbedCPF",
    "register_policy",
    "unregister_policy",
    "get_policy",
    "list_policies",
    "NAIVE_POLICIES",
]

# shared-queue baseline schedulers handled natively by the simulator — kept
# out of the registry because they are not priority policies (dispatch
# architecture differs, not the op order heuristic)
NAIVE_POLICIES = ("fifo", "random")


@dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may consult, computed once per simulation.

    ``scratch`` is per-simulation policy scratch space (policies are
    stateless singletons shared across concurrent simulations; anything
    derived from the context is memoized here, not on the policy).
    """

    graph: Graph
    costs: Mapping[str, float]         # per-op seconds (measured or analytic)
    levels: Mapping[str, float]        # §4.3 level: cost-to-sink incl. self
    depths: Mapping[str, int]          # ASAP wave index (unit-cost from sources)
    n_executors: int
    seed: int = 0
    scratch: dict = field(default_factory=dict)


@runtime_checkable
class SchedulePolicy(Protocol):
    """The policy protocol: a name, a priority function, and an optional
    executor-assignment hook.  Duck-typed — any object with these members
    registers; ``randomized`` tells the search to try several seeds."""

    name: str
    randomized: bool

    def priorities(self, ctx: PolicyContext) -> Mapping[str, float]:
        """Static per-node priority (higher pops first among ready ops)."""
        ...  # pragma: no cover - protocol

    def assign_executor(
        self, ctx: PolicyContext, op: str, free: tuple[int, ...]
    ) -> int | None:
        """Pick an executor among ``free`` (the ids free earliest, sorted)
        or ``None`` for the engine's default placement."""
        ...  # pragma: no cover - protocol


class CriticalPathFirst:
    """The paper's CPF: schedule the op with the longest remaining
    critical path first."""

    name = "cpf"
    randomized = False

    def priorities(self, ctx: PolicyContext) -> Mapping[str, float]:
        return ctx.levels

    def assign_executor(self, ctx, op, free):
        return None


class LevelPack:
    """Pack ASAP waves in order; steer each op to the executor matching its
    position within the wave, so consecutive waves keep producer→consumer
    chains executor-aligned (Opara-style op-stream packing)."""

    name = "level-pack"
    randomized = False

    def priorities(self, ctx: PolicyContext) -> Mapping[str, float]:
        return {n: -float(d) for n, d in ctx.depths.items()}

    def assign_executor(self, ctx, op, free):
        pos = ctx.scratch.get("level-pack.wavepos")
        if pos is None:
            pos = {}
            counts: dict[int, int] = {}
            for n in ctx.graph.names:          # stable node-id order
                d = ctx.depths[n]
                pos[n] = counts.get(d, 0)
                counts[d] = pos[n] + 1
            ctx.scratch["level-pack.wavepos"] = pos
        want = pos[op] % ctx.n_executors
        return want if want in free else None


class LongestProcessingTime:
    """Biggest ready op first (LPT list scheduling)."""

    name = "lpt"
    randomized = False

    def priorities(self, ctx: PolicyContext) -> Mapping[str, float]:
        return ctx.costs

    def assign_executor(self, ctx, op, free):
        return None


class PerturbedCPF:
    """CPF levels scaled by seeded uniform noise in ``1 ± epsilon``.

    One instance is one *distribution*; a concrete draw is fixed by the
    simulation seed, so a (policy, seed) pair names a schedule exactly —
    the searched winner record replays bit-identically.
    """

    name = "cpf-perturb"
    randomized = True

    def __init__(self, epsilon: float = 0.25):
        if not 0.0 < epsilon < 1.0:
            raise ValueError(f"epsilon must be in (0, 1), got {epsilon}")
        self.epsilon = epsilon

    def priorities(self, ctx: PolicyContext) -> Mapping[str, float]:
        rng = random.Random(ctx.seed)
        eps = self.epsilon
        # iterate in node-id order so a seed draws the same noise sequence
        # regardless of dict history
        return {
            n: ctx.levels[n] * (1.0 + eps * (2.0 * rng.random() - 1.0))
            for n in ctx.graph.names
        }

    def assign_executor(self, ctx, op, free):
        return None


# -- the registry ------------------------------------------------------------
_REGISTRY: dict[str, SchedulePolicy] = {}


def register_policy(policy: SchedulePolicy, *, replace: bool = False) -> SchedulePolicy:
    """Add ``policy`` to the registry under ``policy.name``; returns it so
    the call composes as a decorator-ish one-liner.  Registering an existing
    name raises unless ``replace=True`` (silent shadowing would make
    schedule provenance — the persisted winner records — ambiguous)."""
    if not isinstance(policy, SchedulePolicy):
        raise TypeError(
            f"{policy!r} does not implement SchedulePolicy "
            "(name/randomized/priorities/assign_executor)"
        )
    if policy.name in NAIVE_POLICIES:
        raise ValueError(
            f"{policy.name!r} is reserved for the naive shared-queue "
            "simulator baselines"
        )
    if policy.name in _REGISTRY and not replace:
        raise ValueError(
            f"policy {policy.name!r} is already registered "
            "(pass replace=True to shadow it)"
        )
    _REGISTRY[policy.name] = policy
    return policy


def unregister_policy(name: str) -> None:
    """Remove a registered policy (tests; undoing an experiment)."""
    _REGISTRY.pop(name, None)


def get_policy(policy: "str | SchedulePolicy") -> SchedulePolicy:
    """Resolve a policy name through the registry; instances pass through
    (an unregistered ad-hoc policy is usable without registering)."""
    if isinstance(policy, str):
        try:
            return _REGISTRY[policy]
        except KeyError:
            raise ValueError(
                f"unknown scheduling policy {policy!r}; registered: "
                f"{sorted(_REGISTRY)} (repro_torch.core.policies.register_policy "
                "adds one; 'fifo'/'random' are simulator baselines, not "
                "registry policies)"
            ) from None
    if not isinstance(policy, SchedulePolicy):
        raise TypeError(f"{policy!r} does not implement SchedulePolicy")
    return policy


def list_policies() -> list[str]:
    """Registered policy names, CPF first (the reference heuristic), then
    the competitors in registration order — the search's candidate order,
    so ties resolve toward CPF."""
    names = list(_REGISTRY)
    if "cpf" in names:
        names.remove("cpf")
        names.insert(0, "cpf")
    return names


register_policy(CriticalPathFirst())
register_policy(LevelPack())
register_policy(LongestProcessingTime())
register_policy(PerturbedCPF())
