"""What decides ``correct``: the program's readings of its first training
steps against the plain reference's, each number beside its limit.

Three numbers, each a worst case, and three steadier ones beside them
(a cell's limits file names those it compares):

* ``loss_gap``: over the steps the reference follows, the largest
  ``|loss - ref| / |ref|``;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient as AdamW takes it (clipped),
  over the reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same of each leaf's change after the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone);
* ``loss1_gap``: the first step's loss alone (the forward pass, before any
  update); ``grad_median_gap`` and ``change_median_gap``: the median
  leaf's gap.

And the check of the modules a run has loaded: none of the JAX package or
JAX itself, compared by whole top-level names.
"""
from __future__ import annotations

import math
import statistics

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_QUIET = 1e-3


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level part (before the first dot)
    is, as a whole, one of :data:`FORBIDDEN` (``repro_torch`` is not
    ``repro``)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _gaps(prog: dict, ref: dict, paths) -> dict:
    """Each leaf's gap: ``|prog - ref|`` over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    paths = list(paths)
    med = statistics.median(ref[p] for p in paths)
    return {p: (abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
                if math.isfinite(prog[p]) else math.inf) for p in paths}


def _worst(gaps: dict) -> tuple[float, tuple]:
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def _median(gaps: dict) -> tuple[float, str]:
    return statistics.median(gaps.values()), "median leaf"


def compare(prog: dict, ref: dict) -> dict:
    """``{number: (value, worst leaf or step)}``: the three worst cases, and
    three steadier numbers beside them (the first step's loss, the median
    leaf's gradient and change gaps) for a cell whose worst case is one
    leaf's noise."""
    loss = [(abs(a - r) / abs(r) if math.isfinite(a) else math.inf, i + 1)
            for i, (a, r) in enumerate(zip(prog["loss"], ref["loss"]))]
    worst_loss = max(loss)
    grad = _gaps(prog["grad"], ref["grad"], ref["grad"])
    med = statistics.median(ref["raw_grad"].values())
    moved = [p for p, g in ref["raw_grad"].items() if g >= _QUIET * med]
    change = _gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": (worst_loss[0], f"step {worst_loss[1]}"),
            "loss1_gap": (loss[0][0], "step 1"),
            "grad_gap": _worst(grad), "grad_median_gap": _median(grad),
            "change_gap": _worst(change), "change_median_gap": _median(change)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})`` over the numbers that
    ``limits`` holds (a cell may leave one out, with its reason beside its
    limits)."""
    shown = {k: {"value": v, "limit": limits[k]} for k, (v, _) in numbers.items()
             if k in limits}
    ok = all(math.isfinite(s["value"]) and s["value"] <= s["limit"] for s in shown.values())
    return ok, shown
