"""Contention model: per-op-class interference coefficients measured by the
co-location harness, persisted in the calibration store, and fed back into
both the simulator (duration adjustment) and placement (a registered
``SchedulePolicy`` that keeps high-contention classes apart).

This replaces the scalar ``duration_multiplier`` guess in
:mod:`repro_torch.core.simulate` with measured structure: an op's duration is
scaled by the worst pairwise slowdown against the classes co-resident with
it at dispatch time (max, not product — contended resources saturate, they
don't compound multiplicatively across neighbors).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

from .colocate import InterferenceMatrix

__all__ = [
    "classify",
    "ContentionModel",
    "ContentionAwareCPF",
    "install_contention_policy",
]

# op kind (repro_torch.core.graph.OpNode.kind) -> contended-resource class
# (the axes the co-location harness measures).  The JAX package's table,
# unchanged: the port's own kinds (reduce, lstm_cell, ssm_scan, rglru_scan,
# their backwards) take the elementwise default, as unknown kinds do there.
_KIND_CLASS = {
    "gemm": "gemm",
    "conv": "gemm",          # compute-bound, FMA-port contention
    "attention": "gemm",
    "elementwise": "elementwise",
    "scan": "elementwise",
    "generic": "elementwise",
    "input": "memory",       # pure data movement
}


def classify(node) -> str:
    """Contention class of an op node (duck-typed: anything with ``.kind``)."""
    return _KIND_CLASS.get(getattr(node, "kind", "generic"), "elementwise")


@dataclass
class ContentionModel:
    """Measured interference coefficients between op classes.

    ``pair_slowdown[(a, b)]`` — how much slower class-*a* work runs beside
    class-*b* work than alone (>= 1.0).  Unknown pairs default to 1.0: an
    unmeasured combination must never *inflate* simulated costs.
    """

    solo: dict[str, float] = field(default_factory=dict)
    pair_slowdown: dict[tuple[str, str], float] = field(default_factory=dict)
    # a class is "hot" if any pairing slows it (or its partner) past this
    hot_threshold: float = 1.25
    pinned: bool = False

    @classmethod
    def from_matrix(cls, m: InterferenceMatrix, *,
                    hot_threshold: float = 1.25) -> "ContentionModel":
        pairs = {
            (a, b): m.slowdown(a, b)
            for a in m.classes() for b in m.classes()
        }
        return cls(solo=dict(m.solo), pair_slowdown=pairs,
                   hot_threshold=hot_threshold, pinned=m.pinned)

    def multiplier(self, op_class: str, co_classes: Iterable[str]) -> float:
        """Duration multiplier for ``op_class`` running beside
        ``co_classes``: the worst single pairwise slowdown."""
        worst = 1.0
        for c in co_classes:
            worst = max(worst, self.pair_slowdown.get((op_class, c), 1.0))
        return worst

    def multiplier_for(self, node, co_nodes: Iterable) -> float:
        """Node-level entry point for the simulator: classify the op and
        its co-residents, return the duration multiplier."""
        return self.multiplier(classify(node), (classify(n) for n in co_nodes))

    def pair_cost(self, a: str, b: str) -> float:
        """Symmetric badness of co-scheduling classes ``a`` and ``b`` —
        the placement policy's objective (each direction's slowdown can
        differ; placement cares about the worse one)."""
        return max(self.pair_slowdown.get((a, b), 1.0),
                   self.pair_slowdown.get((b, a), 1.0))

    def hot_classes(self) -> set[str]:
        """Classes involved in any pairing past ``hot_threshold``."""
        hot: set[str] = set()
        for (a, b), s in self.pair_slowdown.items():
            if s > self.hot_threshold:
                hot.add(a)
                hot.add(b)
        return hot

    # -- persistence (CalibrationStore format 3 "interference" section) ----
    def to_dict(self) -> dict:
        return {
            "solo": dict(self.solo),
            "pairs": {f"{a}|{b}": s for (a, b), s in
                      sorted(self.pair_slowdown.items())},
            "hot_threshold": self.hot_threshold,
            "pinned": self.pinned,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ContentionModel":
        pairs: dict[tuple[str, str], float] = {}
        for key, s in d.get("pairs", {}).items():
            a, _, b = key.partition("|")
            pairs[(a, b)] = float(s)
        return cls(
            solo={k: float(v) for k, v in d.get("solo", {}).items()},
            pair_slowdown=pairs,
            hot_threshold=float(d.get("hot_threshold", 1.25)),
            pinned=bool(d.get("pinned", False)),
        )


class ContentionAwareCPF:
    """CPF priorities + contention-aware placement: steer each op onto the
    free executor whose most recent op's class interferes least with it.

    The executor-assignment hook only picks among executors free no later
    than the earliest one (the engine guarantees placement never delays
    dispatch), so this is strictly a *placement* refinement of CPF — with a
    contention-free model it degenerates to CPF exactly, which is what the
    never-worsens bench gate checks.
    """

    randomized = False

    def __init__(self, model: ContentionModel, *, name: str = "cpf-contention"):
        self.name = name
        self.model = model

    def priorities(self, ctx) -> Mapping[str, float]:
        return ctx.levels

    def assign_executor(self, ctx, op, free):
        if not free:
            return None
        last: dict[int, str] = ctx.scratch.setdefault(
            "contention.exec_class", {})
        cls = classify(ctx.graph[op])
        hot = ctx.scratch.get("contention.hot")
        if hot is None:
            hot = self.model.hot_classes()
            ctx.scratch["contention.hot"] = hot
        choice = free[0]
        if cls in hot:
            # among equally-early executors, minimize pairwise contention
            # with each executor's most recent op class; stable (lowest
            # executor id) on ties so schedules stay bit-reproducible
            choice = min(
                free,
                key=lambda e: (self.model.pair_cost(cls, last.get(e, "")), e))
        last[choice] = cls
        return choice


def install_contention_policy(
    model: ContentionModel, *, name: str = "cpf-contention"
) -> ContentionAwareCPF:
    """Register a :class:`ContentionAwareCPF` over ``model`` in the policy
    registry (replacing any previous installation — the model may have been
    re-measured).  Not done at import time: the registry's contents must be
    deterministic, and a contention policy is meaningless without a model.
    """
    from ..core.policies import register_policy

    policy = ContentionAwareCPF(model, name=name)
    register_policy(policy, replace=True)
    return policy
