"""Execution-trace utilities (paper §5.2: "we use the profiling results to
visualize the execution process ... immensely helpful in analysis").

Two parts:

* the graph engine's timeline (:class:`~.simulate.TraceEvent` lists):
  :func:`ascii_timeline` and :func:`trace_csv`;
* the program's own recorder of **spans** and **counters** at the layer
  boundaries of the train step (``train/step.py``, ``optim/adamw.py``,
  ``models/moe.py``), read on the device trace's clock by the benchmark
  (``bench/harness/spans.py``) and exported by ``launch/train.py --spans``.

The recorder is off by default.  Off, a span or a counter costs one check
of a module-level flag: no hook, no kernel.  :func:`enable` turns it on;
spans and counters stay in memory until :func:`snapshot` reads them.  A
span records its name and attributes, its parent's id, its thread (each
thread keeps its own stack of open spans; autograd's device thread runs
the backward and remat's recompute), the id of the step it belongs to
(the innermost open span opened with ``root=True``) and a start and an
end on ``time.time_ns()``, the clock ``torch.profiler``'s trace is on
(its ``ts`` plus ``baseTimeNanoseconds`` / 1000 is that clock in µs, up
to an offset the benchmark measures).  A span opened on a thread with no
open span takes as parent the innermost open span of the step's own
thread.  Counters are host integers (:func:`count`) or device tensors
added to without a sync (:func:`accumulate`), read at :func:`snapshot`;
each is kept per step.

While ``make_fx`` or FX traces, under a ``FakeTensorMode``, on a fake or
DTensor input (``of=``) and inside :func:`quiet`, spans and counters
record nothing and no hook is registered, so a captured graph has the
same nodes with the recorder on as with it off.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Sequence

from .simulate import TraceEvent

__all__ = ["ascii_timeline", "trace_csv",
           "enable", "disable", "reset", "live", "span", "quiet", "backward_spans",
           "count", "accumulate", "snapshot", "chrome_events", "capturing"]


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


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

_ON = False
_ids = itertools.count(1)
_spans: list = []         # closed spans: (id, name, attrs, parent, tid, step, t0_ns, t1_ns)
_counts: dict = {}        # (name, step) -> int
_device: dict = {}        # (name, step) -> 0-dim device tensor
_local = threading.local()
_root: list = []          # the open root spans: [(span, its thread's stack)]
_lock = threading.Lock()  # the counters' read-modify-writes


class _Off:
    """The context every span is while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Quiet:
    """Silences the recorder on this thread for its body."""
    __slots__ = ()

    def __enter__(self):
        _local.quiet = getattr(_local, "quiet", 0) + 1

    def __exit__(self, *exc):
        _local.quiet -= 1
        return False


_QUIET = _Quiet()


class _Span:
    """A span: opened by ``with`` (or :func:`_begin`), closed by :func:`_end`."""
    __slots__ = ("id", "name", "attrs", "parent", "tid", "step", "t0", "stack", "root")

    def __init__(self, name: str, root: bool, attrs: dict):
        self.name, self.root, self.attrs = name, root, attrs

    def __enter__(self):
        return _open(self)

    def __exit__(self, *exc):
        _end(self)
        return False


def enable() -> None:
    """Turn the recorder on (spans and counters from here on are kept)."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn the recorder off; what it holds stays until :func:`reset`."""
    global _ON
    _ON = False


def reset() -> None:
    """Forget every span and counter (open spans still close, unrecorded
    unless the recorder is on)."""
    _spans.clear()
    _counts.clear()
    _device.clear()


_probes: list = []        # torch's capture checks, bound at first use


def _bind_probes() -> list:
    import torch
    from torch._C import _get_dispatch_mode, _TorchDispatchModeKey

    proxy, fake = _TorchDispatchModeKey.PROXY, _TorchDispatchModeKey.FAKE
    fx = torch.fx._symbolic_trace

    def probe():
        return (_get_dispatch_mode(proxy) is not None or _get_dispatch_mode(fake) is not None
                or getattr(fx, "_is_fx_tracing_flag", False) or torch.compiler.is_compiling())

    _probes[:] = [probe, torch.Tensor]
    return _probes


def capturing() -> bool:
    """Whether ``make_fx``, FX or ``torch.compile`` is tracing, or a
    ``FakeTensorMode`` is on, on this thread."""
    return (_probes or _bind_probes())[0]()


def _stand_in(t) -> bool:
    """A fake tensor or a DTensor: a capture's or a rank's, not recorded.
    A plain tensor is neither, and is told apart without an import (the
    first import of ``torch.distributed.tensor`` takes seconds)."""
    if type(t) is (_probes or _bind_probes())[1]:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    return isinstance(t, (FakeTensor, DTensor))


def live(of=None) -> bool:
    """Whether spans and counters record here: the recorder is on, this
    thread is not inside :func:`quiet`, nothing is being captured, and
    ``of`` (a tensor, when given) is neither fake nor a DTensor."""
    if not _ON or getattr(_local, "quiet", 0):
        return False
    return not (capturing() or (of is not None and _stand_in(of)))


def quiet():
    """A context in which this thread records nothing (a DTensor rank's
    local calls, say)."""
    return _QUIET if _ON else _OFF


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
        _local.tid = threading.get_native_id()     # a system call: once a thread
    return s


def _begin(name: str) -> _Span:
    """Open a span on this thread's stack; :func:`_end` closes it (from the
    same thread, as an autograd hook does)."""
    return _open(_Span(name, False, {}))


def _open(s: _Span) -> _Span:
    stack = _stack()
    s.id, s.stack, s.tid = next(_ids), stack, _local.tid
    root = s.root
    if stack:
        s.parent = stack[-1].id
    elif _root and _root[-1][1]:
        s.parent = _root[-1][1][-1].id       # the step's thread's innermost span
    else:
        s.parent = None
    s.step = s.id if root else (_root[-1][0].id if _root else None)
    stack.append(s)
    if root:
        _root.append((s, stack))
    s.t0 = time.time_ns()
    return s


def _end(s: _Span) -> None:
    """Close ``s`` (and record it while the recorder is on)."""
    t1 = time.time_ns()
    stack = s.stack
    if stack and stack[-1] is s:
        stack.pop()
    elif s in stack:
        stack.remove(s)
    if s.root:
        _root[:] = [r for r in _root if r[0] is not s]
    if _ON:
        _spans.append((s.id, s.name, s.attrs, s.parent, s.tid, s.step, s.t0, t1))


def span(name: str, *, of=None, root: bool = False, **attrs: Any):
    """``with span("train.forward"): ...``: a span around the body, with
    ``attrs`` (small JSON values).  ``root=True`` marks a step's root: the
    spans and counters inside belong to its step.  Off, or not
    :func:`live` for ``of``, it records nothing; where it is silenced by
    a capture or a stand-in tensor, its body is silenced too."""
    if not _ON:
        return _OFF
    if getattr(_local, "quiet", 0):
        return _OFF
    if capturing() or (of is not None and _stand_in(of)):
        return _QUIET
    return _Span(name, root, attrs)


def backward_spans(tensors: Sequence, names: Sequence[str]) -> bool:
    """Spans in the backward pass between the gradients of ``tensors``
    (in the order the backward reaches them): ``names[i]`` opens when the
    gradient of ``tensors[i]`` is ready and closes when that of
    ``tensors[i + 1]`` is, by hooks on the tensors.  Call it inside the
    forward, while :func:`live`; registers nothing (and returns False)
    unless every tensor requires grad."""
    if len(tensors) != len(names) + 1 or not all(t.requires_grad for t in tensors):
        return False
    open_: list = []

    def at(i):
        def hook(_grad):
            if open_:
                _end(open_.pop())
            if i < len(names):
                open_.append(_begin(names[i]))
        return hook

    for i, t in enumerate(tensors):
        t.register_hook(at(i))
    return True


def _step_id():
    return _root[-1][0].id if _root else None


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` of this step."""
    if _ON and live():
        key = (name, _step_id())
        with _lock:
            _counts[key] = _counts.get(key, 0) + int(n)


def accumulate(name: str, value) -> None:
    """Add the device tensor ``value`` (0-dim, no gradient) to the counter
    ``name`` of this step, on the device, without a sync; read at
    :func:`snapshot`.  The first value of a step is kept as the sum (not
    copied): pass a tensor of the counter's own."""
    if _ON and live(value):
        key = (name, _step_id())
        with _lock:
            acc = _device.get(key)
            if acc is None:
                _device[key] = value
            else:
                acc.add_(value)


def snapshot() -> dict:
    """What the recorder holds: ``{"clock": "time_ns", "spans": [...],
    "counters": {name: {step: value}}}``, each span a dict with ``id``,
    ``name``, ``attrs``, ``parent``, ``tid``, ``step``, ``t0_ns``,
    ``t1_ns``; counter steps as strings (None: outside any step).  Reads
    the device counters (the one sync)."""
    spans = [dict(id=i, name=n, attrs=a, parent=p, tid=t, step=st, t0_ns=t0, t1_ns=t1)
             for i, n, a, p, t, st, t0, t1 in list(_spans)]
    counters: dict = {}
    for (name, step), v in list(_counts.items()):
        counters.setdefault(name, {})[str(step)] = v
    for (name, step), v in list(_device.items()):
        x = v.item()
        counters.setdefault(name, {})[str(step)] = int(x) if float(x).is_integer() else x
    return {"clock": "time_ns", "spans": spans, "counters": counters}


def chrome_events(snap: dict) -> dict:
    """A snapshot as a Chrome trace, on ``torch.profiler``'s time base:
    each span an ``X`` event whose ``ts`` plus ``baseTimeNanoseconds`` /
    1000 is its start in µs of ``time.time_ns()``, as in the profiler's
    own export; each counter a ``C`` event at the end of its step."""
    spans = snap["spans"]
    base = (min(s["t0_ns"] for s in spans) // 10**9) * 10**9 if spans else 0
    events = []
    ends = {}
    for s in spans:
        if s["id"] == s["step"]:
            ends[str(s["id"])] = s["t1_ns"]
        events.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": 0,
                       "tid": s["tid"], "ts": (s["t0_ns"] - base) / 1e3,
                       "dur": (s["t1_ns"] - s["t0_ns"]) / 1e3,
                       "args": {**s["attrs"], "id": s["id"], "parent": s["parent"],
                                "step": s["step"]}})
    for name, by_step in snap["counters"].items():
        for step, v in by_step.items():
            t = ends.get(step, base)
            events.append({"ph": "C", "cat": "program_counter", "name": name, "pid": 0,
                           "ts": (t - base) / 1e3, "args": {name: v}})
    return {"traceEvents": events, "baseTimeNanoseconds": base, "displayTimeUnit": "ms"}
