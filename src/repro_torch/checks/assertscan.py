"""W-ASSERT: no bare ``assert`` statements in library code.

``python -O`` strips asserts, so an invariant guarded by one silently stops
being checked in optimized deployments.  The library was swept to typed
exceptions (``GraphValidationError`` / ``ValueError`` / ``RuntimeError``);
this rule keeps regressions out.  Error severity on purpose: the CI checks
job must block a reintroduced assert, not shrug at it.

Scans with ``ast`` (not grep) so strings, comments, and doctests never
false-positive.  Test trees are exempt by default — pytest asserts are the
idiom there.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .report import Report

__all__ = ["scan_asserts", "LIBRARY_ROOT"]

# src/repro_torch — the tree the no-assert contract covers
LIBRARY_ROOT = Path(__file__).resolve().parents[1]


def scan_asserts(root: str | Path | None = None) -> Report:
    """Scan ``root`` (default: the installed ``repro_torch`` package tree) for
    ``assert`` statements; one W-ASSERT error finding per occurrence."""
    rep = Report()
    base = Path(root) if root is not None else LIBRARY_ROOT
    if base.is_file():
        files = [base]
        rel_to = base.parent
    else:
        files = sorted(base.rglob("*.py"))
        rel_to = base
    n_files = 0
    for py in files:
        try:
            tree = ast.parse(py.read_text(encoding="utf-8"), filename=str(py))
        except SyntaxError as e:
            rep.add("W-PARSE", "error", f"unparseable: {e}",
                    where=str(py.relative_to(rel_to)))
            continue
        n_files += 1
        where = str(py.relative_to(rel_to))
        for node in ast.walk(tree):
            if isinstance(node, ast.Assert):
                rep.add(
                    "W-ASSERT", "error",
                    f"bare assert at line {node.lineno} — python -O strips "
                    "it; raise a typed exception instead",
                    where=where,
                )
    if rep.ok:
        rep.add("W-ASSERT", "info",
                f"{n_files} file(s) scanned, no bare asserts",
                where=str(base))
    return rep
