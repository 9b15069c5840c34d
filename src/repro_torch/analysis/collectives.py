"""Collective traffic summary of a rank's traced program — the port of the
JAX package's ``analysis/hlo_collectives.py``.

A thin facade over :mod:`repro_torch.analysis.fx_cost`: the collectives are
the ``_c10d_functional`` nodes of the rank's fx graph (DTensor's
redistributions and the explicit ones), each loop already unrolled by
``make_fx``.

Convention: bytes are the **operand** (pre-collective, per-rank) sizes —
the payload each rank contributes.  Ring-transfer inflation factors
(2(k-1)/k for all-reduce etc.) are the roofline's business, not this one's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .fx_cost import COLLECTIVE_KINDS, module_cost

__all__ = ["collective_bytes", "collective_summary", "CollectiveStats", "COLLECTIVE_KINDS"]


@dataclass
class CollectiveStats:
    # kind -> (count, operand bytes)
    per_kind: dict[str, tuple[int, float]] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(b for _, b in self.per_kind.values())

    @property
    def total_count(self) -> int:
        return sum(c for c, _ in self.per_kind.values())

    def table(self) -> str:
        rows = [f"{'kind':20s} {'count':>6s} {'MiB':>10s}"]
        for kind in COLLECTIVE_KINDS:
            if kind in self.per_kind:
                c, b = self.per_kind[kind]
                rows.append(f"{kind:20s} {c:6d} {b / 2**20:10.2f}")
        rows.append(f"{'TOTAL':20s} {self.total_count:6d} {self.total_bytes / 2**20:10.2f}")
        return "\n".join(rows)


def collective_summary(gm) -> CollectiveStats:
    """Per-kind counts and operand bytes of a traced ``GraphModule``."""
    return CollectiveStats(per_kind=dict(module_cost(gm).collectives))


def collective_bytes(gm) -> float:
    return collective_summary(gm).total_bytes
