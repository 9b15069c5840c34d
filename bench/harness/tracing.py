"""Traced segments of steps: ``torch.profiler`` over the calls, the Chrome
trace written inside the checkout and read back.

What the per-layer readers get (:class:`Trace`): every device operation
(kernels, copies, fills) with its name, start and length; the kernels
alone; the traced window's length on the host clock; the union of the
device intervals (busy seconds); and the idle gaps, each named by the
innermost host operation running at its middle.

Recording every host operation slows a step whose pace the host sets, so
the device's numbers come from a segment that records device activity
alone, and the gaps' names from a second, shorter segment that records the
host's operations too (its gaps are those of a slowed host).
"""
from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")
_NAMED_GAPS = 2000


def base_name(name: str) -> str:
    """A kernel's own name without its return type, namespace, template
    arguments or parameters: ``void (anonymous namespace)::flash_fwd_mma<
    __nv_bfloat16, 128>(...)`` is ``flash_fwd_mma``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


@dataclass
class Trace:
    steps: int
    window_s: float
    ops: list = field(default_factory=list)      # (name, start_us, dur_us) device ops
    kernels: list = field(default_factory=list)  # the kernels among them
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)     # (host op name, seconds)

    def kernel_seconds(self, prefixes: tuple) -> float:
        """Device seconds of the kernels whose name starts with one of
        ``prefixes``."""
        return sum(d for n, _, d in self.kernels if base_name(n).startswith(prefixes)) / 1e6

    def count(self, prefixes: tuple) -> int:
        """Launches of the kernels whose name starts with one of ``prefixes``."""
        return sum(1 for n, _, _ in self.kernels if base_name(n).startswith(prefixes))

    def breakdown(self, n: int = 10) -> dict:
        by_op: dict = {}
        for name, _, dur in self.ops:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        by_gap: dict = {}
        for name, sec in self.gaps:
            by_gap[name] = by_gap.get(name, 0.0) + sec
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in idle]}


def profile(run_steps, steps: int, out: Path, *, host: bool) -> Trace:
    """Trace ``run_steps(steps)`` (which ends in a device synchronise); the
    host's operations too where ``host``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        window_s = time.perf_counter() - t0
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    return read(out, steps, window_s)


def read(path: Path, steps: int, window_s: float) -> Trace:
    events = json.loads(Path(path).read_text())["traceEvents"]
    ops, host = [], []
    lo = hi = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            ops.append((e["name"], ts, dur, cat))
        elif cat in _HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
            if e["name"].startswith("bench."):
                lo = ts if lo is None else min(lo, ts)
                hi = ts + dur if hi is None else max(hi, ts + dur)
    ops.sort(key=lambda o: o[1])
    tr = Trace(steps=steps, window_s=window_s,
               ops=[(n, s, d) for n, s, d, _ in ops],
               kernels=[(n, s, d) for n, s, d, c in ops if c == "kernel"])
    # busy: the union of the device intervals; gaps: the holes between them
    merged: list = []
    for _, s, d, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    tr.busy_s = sum(e - s for s, e in merged) / 1e6
    holes = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged and lo is not None:
        holes.append((merged[0][0] - lo, lo, merged[0][0]))
    if merged and hi is not None:
        holes.append((hi - merged[-1][1], merged[-1][1], hi))
    holes = sorted((h for h in holes if h[0] > 0), reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, s, e in holes[:_NAMED_GAPS]:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: no operation"
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        named.append((name, length / 1e6))
    rest = sum(h[0] for h in holes[_NAMED_GAPS:]) / 1e6
    if rest:
        named.append((f"gaps below the {_NAMED_GAPS} longest", rest))
    tr.gaps = named
    return tr
