"""The program's own spans and counters on the device trace's clock.

A segment (:func:`segment`) runs ``trace_steps`` more steps with the
program's recorder on (``repro_torch.core.trace``) under a profiler that
records device activity alone (a program without the recorder gives
None).  Clock markers before and after the steps, each a span
``bench.clock`` around one launch of ``torch.cuda._sleep`` (kernel
``spin_kernel``), place the program's clock on the trace's.  It writes
``<cell>.spans.trace.json`` (the profiler's) and ``<cell>.spans.json``
(the program's snapshot and what :func:`read` makes of both).

:func:`read` joins each device operation to its launch (the
``cuda_runtime`` / ``cuda_driver`` event of the same ``correlation``; a
trace with device operations and no launch event raises) and attributes it to the innermost program span open at the launch on the
launching thread (else the innermost open on any thread: autograd's device
thread between the MoE backward spans runs inside the step's
``train.backward``); names each idle gap by the innermost span open on any
thread at its midpoint; and gives, per span label (a span's name,
``.recompute`` added in remat's recompute) and per step, device ms,
launches, host ms and idle ms (each inclusive of the span's children, and
``self_`` without them), with the counters.  The readers of the spans'
per-layer metrics take the functions at the end.
"""
from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

from harness import tracing
from harness.tracing import _DEVICE_CATS, base_name

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "bench.clock"
MARKER_KERNEL = "spin_kernel"
MARKERS = 32                     # before the steps, and as many after
BURST_GAP_US = 50e3              # markers of one burst lie closer than this
PAD_S = 0.25                     # the profiler's edges kept clear of the work
PHASES = ("train.batch", "train.forward", "train.backward", "train.accumulate",
          "train.optimizer")
# the MoE spans' labels: forward, remat's recompute, backward
ROUTING_LABELS = tuple(name + part for name in ("moe.route", "moe.dispatch", "moe.combine")
                       for part in ("", ".recompute", ".bwd"))
EXPERT_LABELS = ("moe.experts", "moe.experts.recompute", "moe.experts.bwd")
_STATS = ("device_ms", "self_device_ms", "launches", "self_launches", "host_ms", "count",
          "idle_ms", "self_idle_ms")


def label(span: dict) -> str:
    return span["name"] + (".recompute" if span["attrs"].get("recompute") else "")


# ---------------------------------------------------------------------------
# the segment
# ---------------------------------------------------------------------------

def _recorder():
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "snapshot") and hasattr(trace, "enable") else None


def segment(run_steps, steps: int, out: Path, name: str) -> dict | None:
    """``run_steps(steps)`` (which ends in a device synchronise) with the
    program's recorder on, between two bursts of clock markers, under
    :func:`harness.tracing.profile` recording the device alone; None where
    the program has no recorder.  Writes the two files under ``out`` and
    returns :func:`read`'s summary."""
    trace = _recorder()
    if trace is None:
        return None
    import torch

    def markers():
        for _ in range(MARKERS):
            with trace.span(MARKER):
                torch.cuda._sleep(64)
        torch.cuda.synchronize()

    def padded(k):
        time.sleep(PAD_S)
        markers()
        run_steps(k)
        markers()
        time.sleep(PAD_S)

    torch.cuda._sleep(64)
    trace_path = out / f"{name}.spans.trace.json"
    trace.reset()
    trace.enable()
    try:
        tracing.profile(padded, steps, trace_path, host=False)
    finally:
        trace.disable()
    snap = trace.snapshot()
    trace.reset()
    summary = read(json.loads(trace_path.read_text()), snap)
    (out / f"{name}.spans.json").write_text(json.dumps({"summary": summary, "program": snap}))
    return summary


def traced(r, prog, out: Path) -> dict | None:
    """The segment after a run's traced ones (``harness.train.traced``):
    ``trace_steps`` more of the window's steps on its state."""
    import torch

    def run_steps(k):
        for _ in range(k):
            prog.state, _ = prog.step(prog.state, prog.pool[prog.steps % len(prog.pool)])
            prog.steps += 1
        torch.cuda.synchronize(r.device)

    return segment(run_steps, int(r.cell.traffic["trace_steps"]), out, r.cell.name)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def _bursts(items: list, at, gap_us: float) -> list:
    """``items`` (sorted by ``at``) split where ``at`` jumps by more than
    ``gap_us``."""
    out: list = []
    for x in items:
        if out and at(x) - at(out[-1][-1]) <= gap_us:
            out[-1].append(x)
        else:
            out.append([x])
    return out


def clock_offset(spans: list, launches: list, base_ns: int) -> dict:
    """The trace clock less the program's, in µs, from the markers: each
    ``bench.clock`` span holds the launch of one ``spin_kernel``
    (``launches``: ``(ts, end)`` in trace µs).  Markers come in bursts (one
    before the steps, one after); a burst of spans is paired in order with
    a burst of as many launches, and every pair bounds the offset on both
    sides.  The bounds of the pairings that agree meet in an interval whose
    middle is the offset and whose half-width is how well it is known.  A
    burst whose kernels the trace lost pairs with none."""
    marks = sorted((s for s in spans if s["name"] == MARKER), key=lambda s: s["t0_ns"])
    span_bursts = _bursts(marks, lambda s: s["t0_ns"] / 1e3, BURST_GAP_US)
    launch_bursts = _bursts(sorted(launches), lambda x: x[0], BURST_GAP_US)
    found = []
    for sb in span_bursts:
        for lb in launch_bursts:
            if len(sb) != len(lb):
                continue
            lo = max(le - (s["t1_ns"] - base_ns) / 1e3 for s, (_, le) in zip(sb, lb))
            hi = min(ls - (s["t0_ns"] - base_ns) / 1e3 for s, (ls, _) in zip(sb, lb))
            found.append((lo, hi, len(sb)))
    agree = [f for f in found if f[0] <= f[1]]
    if agree:
        a, b = max(f[0] for f in agree), min(f[1] for f in agree)
        if a <= b:
            return {"offset_us": 0.5 * (a + b), "within_us": 0.5 * (b - a),
                    "markers": sum(f[2] for f in agree), "marker_spans": len(marks),
                    "marker_kernels": len(launches), "consistent": True}
    best = min(found, key=lambda f: f[0] - f[1], default=None)
    return {"offset_us": None if best is None else 0.5 * (best[0] + best[1]),
            "within_us": None if best is None else 0.5 * abs(best[0] - best[1]),
            "markers": 0, "marker_spans": len(marks), "marker_kernels": len(launches),
            "consistent": False}


def busy_intervals(ops) -> list:
    """The union of device intervals, ``(start, length)`` pairs sorted by
    start, as ``[start, end]`` lists: the busy time, whose holes are the
    idle gaps (the same union ``harness.tracing.read`` makes)."""
    merged: list = []
    for ts, dur in ops:
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    return merged


def holes(merged: list, lo: float, hi: float) -> list:
    """The gaps of :func:`busy_intervals`' union within ``[lo, hi]``: between
    its intervals, and from ``lo`` to the first and from the last to ``hi``."""
    if not merged:
        return [(lo, hi)] if hi > lo else []
    edges = [(lo, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    edges.append((merged[-1][1], hi))
    return [(max(a, lo), min(b, hi)) for a, b in edges if min(b, hi) > max(a, lo)]


class _Index:
    """Program spans on the trace's clock: the innermost open at a time, on
    one thread or on any."""

    def __init__(self, spans: list, shift_us: float, base_ns: int):
        self.spans = {s["id"]: s for s in spans}
        self.t0 = {i: (s["t0_ns"] - base_ns) / 1e3 + shift_us for i, s in self.spans.items()}
        self.t1 = {i: (s["t1_ns"] - base_ns) / 1e3 + shift_us for i, s in self.spans.items()}
        self.depth: dict = {}
        for i in self.spans:
            self._depth(i)
        self.threads: dict = {}
        for i, s in self.spans.items():
            self.threads.setdefault(s["tid"], []).append(i)
        self.starts, self.outer = {}, {}
        for tid, ids in self.threads.items():
            ids.sort(key=lambda i: (self.t0[i], -self.t1[i]))
            stack = []
            for i in ids:
                while stack and self.t1[stack[-1]] < self.t0[i]:
                    stack.pop()
                self.outer[i] = stack[-1] if stack else None
                stack.append(i)
            self.starts[tid] = [self.t0[i] for i in ids]

    def _depth(self, i) -> int:
        if i not in self.depth:
            p = self.spans[i]["parent"]
            self.depth[i] = 0 if p not in self.spans else 1 + self._depth(p)
        return self.depth[i]

    def on_thread(self, t: float, tid):
        ids = self.threads.get(tid)
        if not ids:
            return None
        k = bisect.bisect_right(self.starts[tid], t) - 1
        i = ids[k] if k >= 0 else None
        while i is not None and self.t1[i] < t:
            i = self.outer[i]
        return i

    def anywhere(self, t: float):
        best = None
        for tid in self.threads:
            i = self.on_thread(t, tid)
            if i is not None and (best is None or self.depth[i] > self.depth[best]):
                best = i
        return best

    def chain(self, i):
        while i in self.spans:
            yield i
            i = self.spans[i]["parent"]


def read(chrome: dict, snap: dict) -> dict:
    """The summary of one segment: the profiler's Chrome trace (as loaded)
    and the program's snapshot (``repro_torch.core.trace.snapshot()``)."""
    base_ns = int(chrome.get("baseTimeNanoseconds", 0))
    ops, launches = [], {}
    for e in chrome["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            ops.append((ts, dur, e["name"], cat, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, ts + dur, e.get("tid"))
    if ops and not launches:
        raise ValueError("the trace holds device operations and no launch event: its "
                         "kernels cannot be joined to the program's spans")
    ops.sort(key=lambda o: o[0])
    marker_launches = [launches[c][:2] for ts, _, n, cat, c in ops
                       if cat == "kernel" and base_name(n) == MARKER_KERNEL and c in launches]
    clock = clock_offset(snap["spans"], marker_launches, base_ns)
    shift = clock["offset_us"] or 0.0
    spans = [s for s in snap["spans"] if s["name"] != MARKER]
    idx = _Index(spans, shift, base_ns)
    roots = sorted((i for i, s in idx.spans.items() if s["step"] == i), key=idx.t0.get)
    n_steps = len(roots)
    out = {**clock, "steps": n_steps, "launch_events": len(launches)}
    if not roots:
        return {**out, "labels": {}, "by_step": {}, "counters": {}, "by_kernel": {}}
    # the steps: the device operations launched inside their roots, on the
    # device until the last of them ends (the host runs ahead of it)
    lo, hi = idx.t0[roots[0]], idx.t1[roots[-1]]
    mine = [o for o in ops if o[4] in launches and lo <= launches[o[4]][0] <= hi]
    end = max((ts + dur for ts, dur, *_ in mine), default=hi)
    mine += [o for o in ops if o[4] not in launches and lo <= o[0] <= end]
    mine.sort(key=lambda o: o[0])

    by_step: dict = {}

    def add(step, lab, key, v):
        d = by_step.setdefault(str(step), {}).setdefault(lab, dict.fromkeys(_STATS, 0.0))
        d[key] += v

    def credit(i, stat, v):
        s = idx.spans[i]
        add(s["step"], label(s), "self_" + stat, v)
        seen = set()
        for j in idx.chain(i):
            lab = label(idx.spans[j])
            if lab not in seen:
                seen.add(lab)
                add(s["step"], lab, stat, v)

    for i, s in idx.spans.items():
        add(s["step"], label(s), "host_ms", (idx.t1[i] - idx.t0[i]) / 1e3)
        add(s["step"], label(s), "count", 1)

    by_kernel: dict = {}
    lags = sorted(ts - launches[c][0] for ts, _, _, cat, c in mine
                  if cat == "kernel" and c in launches)
    sums = {"device_ms": 0.0, "attributed_ms": 0.0, "unlaunched_ms": 0.0,
            "on_thread_ms": 0.0, "kernels": 0}
    for ts, dur, name, cat, corr in mine:
        sums["device_ms"] += dur / 1e3
        sums["kernels"] += cat == "kernel"
        launch = launches.get(corr)
        if launch is None:
            sums["unlaunched_ms"] += dur / 1e3
            continue
        i = idx.on_thread(launch[0], launch[2])
        if i is not None:
            sums["on_thread_ms"] += dur / 1e3
        else:
            i = idx.anywhere(launch[0])
        where = label(idx.spans[i]) if i is not None else "no span"
        k = by_kernel.setdefault(base_name(name), {})
        k[where] = k.get(where, 0.0) + dur / 1e3
        if i is None:
            continue
        sums["attributed_ms"] += dur / 1e3
        credit(i, "device_ms", dur / 1e3)
        if cat == "kernel":
            credit(i, "launches", 1)

    merged = busy_intervals((ts, dur) for ts, dur, *_ in mine)
    idle = 0.0
    named = {}
    for a, b in holes(merged, lo, end):
        idle += (b - a) / 1e3
        i = idx.anywhere(0.5 * (a + b))
        where = label(idx.spans[i]) if i is not None else "no span"
        named[where] = named.get(where, 0.0) + (b - a) / 1e3
        if i is not None:
            credit(i, "idle_ms", (b - a) / 1e3)

    labels: dict = {}
    for per in by_step.values():
        for lab, d in per.items():
            agg = labels.setdefault(lab, dict.fromkeys(_STATS, 0.0))
            for key, v in d.items():
                agg[key] += v / n_steps
    counters = {name: {"per_step": sum(v.values()) / n_steps, "by_step": v}
                for name, v in snap["counters"].items()}
    busy = sum(b - a for a, b in merged) / 1e3
    out.update({
        "window_ms": (end - lo) / 1e3 / n_steps, "busy_ms": busy / n_steps,
        "device_ms": sums["device_ms"] / n_steps, "idle_ms": idle / n_steps,
        "launches": sums["kernels"] / n_steps,
        "attributed_share": sums["attributed_ms"] / sums["device_ms"] if sums["device_ms"] else 0.0,
        "on_thread_share": sums["on_thread_ms"] / sums["device_ms"] if sums["device_ms"] else 0.0,
        "unlaunched_ms": sums["unlaunched_ms"] / n_steps,
        # a kernel starts after its launch; a step's kernels are the same each step
        "launch_to_start_us": {"min": lags[0], "median": lags[len(lags) // 2],
                               "before_launch": sum(1 for x in lags if x < 0)} if lags else None,
        "kernels_by_step": {k: v["train.step"]["launches"] for k, v in by_step.items()
                            if "train.step" in v},
        "idle_by_span": {k: v / n_steps for k, v in sorted(named.items(), key=lambda kv: -kv[1])},
        "labels": labels, "by_step": by_step, "counters": counters,
        "by_kernel": {k: {w: v / n_steps for w, v in d.items()} for k, d in by_kernel.items()},
    })
    return out


# ---------------------------------------------------------------------------
# the per-layer quantities the spans feed (per step)
# ---------------------------------------------------------------------------

def _stat(s: dict, labels, key: str) -> float | None:
    found = [s["labels"][lab][key] for lab in labels if lab in s["labels"]]
    return sum(found) if found else None


def optimizer_ms(s: dict) -> float | None:
    return _stat(s, ("optim.adamw",), "device_ms")


def optimizer_launches(s: dict) -> float | None:
    return _stat(s, ("optim.adamw",), "launches")


def adamw_roofline(s: dict, least_bytes: float, hbm_bytes_per_s: float) -> float | None:
    """The least time of one update (``roofline/adamw.py``'s bytes over the
    peak bandwidth) over the device time of the kernels ``optim.adamw``
    launched, in %."""
    ms = optimizer_ms(s)
    return 100.0 * least_bytes / hbm_bytes_per_s / (ms / 1e3) if ms else None


def routing_ms(s: dict) -> float | None:
    """Device ms of the kernels the routing spans launched themselves
    (``self_``: ``moe.combine.bwd`` holds remat's whole-layer recompute)."""
    return _stat(s, ROUTING_LABELS, "self_device_ms")


def _counter(s: dict, name: str) -> float | None:
    c = s["counters"].get(name)
    return c["per_step"] if c else None


def moe_slot_fill(s: dict) -> float | None:
    kept, slots = _counter(s, "moe.kept"), _counter(s, "moe.slots")
    return 100.0 * kept / slots if kept is not None and slots else None


def moe_kept_share(s: dict) -> float | None:
    kept, claims = _counter(s, "moe.kept"), _counter(s, "moe.claims")
    return 100.0 * kept / claims if kept is not None and claims else None


def share_in(s: dict, kernel_prefixes: tuple, labels: tuple) -> float | None:
    """The share of the device time of the kernels named by
    ``kernel_prefixes`` whose innermost span has one of ``labels``."""
    total = inside = 0.0
    for k, where in s["by_kernel"].items():
        if k.startswith(kernel_prefixes):
            total += sum(where.values())
            inside += sum(v for w, v in where.items() if w in labels)
    return inside / total if total else None
