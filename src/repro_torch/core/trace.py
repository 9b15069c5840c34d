"""Execution-trace utilities (paper §5.2: "we use the profiling results to
visualize the execution process ... immensely helpful in analysis")."""
from __future__ import annotations

from typing import Sequence

from .simulate import TraceEvent

__all__ = ["ascii_timeline", "trace_csv"]


def ascii_timeline(
    trace: Sequence[TraceEvent], n_executors: int, width: int = 100
) -> str:
    """Render per-executor timelines as ASCII (one row per executor)."""
    if not trace:
        return "(empty trace)"
    t_end = max(e.end for e in trace)
    t_end = t_end or 1.0
    rows = []
    for ex in range(n_executors):
        line = [" "] * width
        for ev in trace:
            if ev.executor != ex:
                continue
            a = int(ev.start / t_end * (width - 1))
            b = max(a + 1, int(ev.end / t_end * (width - 1)))
            ch = ev.op[-1] if ev.op else "#"
            for i in range(a, min(b, width)):
                line[i] = "#" if line[i] != " " else ch
        rows.append(f"E{ex:02d} |" + "".join(line) + "|")
    rows.append(f"     0{' ' * (width - 12)}{t_end * 1e6:9.1f}us")
    return "\n".join(rows)


def trace_csv(trace: Sequence[TraceEvent]) -> str:
    lines = ["op,executor,start_us,end_us,duration_us"]
    for e in sorted(trace, key=lambda e: e.start):
        lines.append(
            f"{e.op},{e.executor},{e.start*1e6:.3f},{e.end*1e6:.3f},{(e.end-e.start)*1e6:.3f}"
        )
    return "\n".join(lines)
