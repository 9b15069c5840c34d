"""Common finding/report types for the static verifier (DESIGN.md §3.3).

Every layer of ``repro_torch.checks`` — structural invariants, effect inference,
hazard analysis, source scans — emits the same currency: a :class:`Finding`
``(rule_id, severity, context, message)``.  A :class:`Report` is an ordered
collection of findings with the aggregation the callers need: CLI rendering,
``ok`` gating (error severity only), and ``raise_if_errors`` for the
``check="strict"`` compile path.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator

from repro_torch.core.graph import GraphValidationError

__all__ = ["Finding", "Report", "SEVERITIES"]

SEVERITIES = ("error", "warning", "info")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass(frozen=True)
class Finding:
    """One verifier result.

    ``rule_id`` names the rule (catalog in DESIGN.md §3.3, e.g. ``G-CYCLE``,
    ``P-COUNTER``, ``H-WW``); ``where`` is the artifact the rule ran over
    (graph name, plan name, file path); ``node``/``executor`` narrow the
    location when the rule is about one op or one executor program.
    """

    rule_id: str
    severity: str                      # "error" | "warning" | "info"
    message: str
    where: str = ""
    node: str | None = None
    executor: int | None = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def render(self) -> str:
        loc = self.where
        if self.node is not None:
            loc = f"{loc}:{self.node}" if loc else self.node
        if self.executor is not None:
            loc = f"{loc}@e{self.executor}"
        return f"{self.severity.upper():7s} {self.rule_id:10s} {loc}: {self.message}"

    def __str__(self) -> str:
        return self.render()


@dataclass
class Report:
    """An ordered finding collection; ``ok`` gates on error severity only."""

    findings: list[Finding] = field(default_factory=list)

    # -- building ----------------------------------------------------------
    def add(
        self,
        rule_id: str,
        severity: str,
        message: str,
        *,
        where: str = "",
        node: str | None = None,
        executor: int | None = None,
    ) -> Finding:
        f = Finding(rule_id, severity, message, where=where, node=node,
                    executor=executor)
        self.findings.append(f)
        return f

    def extend(self, other: "Report | Iterable[Finding]") -> "Report":
        self.findings.extend(
            other.findings if isinstance(other, Report) else other)
        return self

    def scoped(self, where: str) -> "Report":
        """A copy with ``where`` filled in on findings that lack one."""
        return Report([
            replace(f, where=where) if not f.where else f
            for f in self.findings
        ])

    # -- aggregation -------------------------------------------------------
    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule_id] = out.get(f.rule_id, 0) + 1
        return out

    def raise_if_errors(self) -> None:
        """Raise :class:`GraphValidationError` listing the error findings
        (the ``check="strict"`` enforcement point)."""
        errs = self.errors
        if errs:
            head = "; ".join(f"{f.rule_id} {f.message}" for f in errs[:4])
            more = f" (+{len(errs) - 4} more)" if len(errs) > 4 else ""
            raise GraphValidationError(
                f"{len(errs)} check error(s): {head}{more}")

    def summary(self) -> str:
        n_e, n_w = len(self.errors), len(self.warnings)
        n_i = len(self.findings) - n_e - n_w
        return f"{n_e} error(s), {n_w} warning(s), {n_i} info"

    def render(self, *, min_severity: str = "info") -> str:
        keep = [f for f in self.findings
                if _RANK[f.severity] <= _RANK[min_severity]]
        if not keep:
            return "clean: no findings"
        ordered = sorted(keep, key=lambda f: (_RANK[f.severity], f.rule_id))
        return "\n".join(f.render() for f in ordered)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def __str__(self) -> str:
        return self.render()
