"""One run of a training cell.

Set-up (counted in ``setup_s``): the port's config checked against the
configuration's file, the weights made on the device from the seed, the
train state built around them (``optim.adamw.adamw_init``), the step from
``train.step.make_train_step``, the batches drawn, and the first steps run
through that same step on rows that all differ.  Those first steps are the
ones the reference follows; they compile and warm every shape the window
uses.  The check's readings between them (each leaf's first moment after
step 1, each leaf's change after the last) are timed apart and left out of
``setup_s``.

The window runs whole steps on the same state until the host clock passes
``seconds``, then synchronises.  A traced run then profiles a few more
steps.  The program's state is freed before the reference runs.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.utils import _pytree as pytree

from harness import check, spec, tracing, traffic
from harness.weights import Weights, keystr
from reference.follow import follow


@dataclass
class Run:
    """What a run measured, for the metric readers and the result line."""
    cell: spec.Cell
    seed: int
    device: torch.device
    setup_s: float = 0.0
    check_s: float = 0.0
    window: dict = field(default_factory=dict)
    setup_peak: int = 0
    window_peak: int = 0
    trace: tracing.Trace | None = None
    program: dict = field(default_factory=dict)
    reference: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)
    reference_s: float = 0.0


def port_config(config: dict):
    """The port's ``ModelConfig`` that the file names, checked key by key
    against the sizes the file states (and the reference uses)."""
    module, attr = config["port_config"].split(":")
    cfg = getattr(importlib.import_module(module), attr)
    for key, want in config["model"].items():
        have = cfg.resolved_head_dim if key == "head_dim" else getattr(cfg, key)
        if isinstance(have, torch.dtype):
            have = str(have).removeprefix("torch.")
        if isinstance(have, tuple):
            have = list(have)
        if have != want:
            raise ValueError(f"{config['port_config']}.{key} is {have!r}; "
                             f"{config['name']}'s file states {want!r}")
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tree) -> list[float]:
    leaves = pytree.tree_leaves(tree)
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in leaves]).tolist()


def _paths(tree) -> list[str]:
    return [pytree.keystr(kp) for kp, _ in pytree.tree_flatten_with_path(tree)[0]]


def start(r: Run, *, step_hook=None) -> SimpleNamespace:
    """The set-up through the first steps and the check's readings of them.
    ``step_hook(step)`` may wrap the program's step (the tests plant faults
    through it).  Returns the program's objects for the window."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cell, dev = r.cell, r.device
    mix, model = cell.traffic, cell.config["model"]
    opt = mix["optimizer"]
    cfg = port_config(cell.config)
    n_check = int(cell.limits["steps"])

    weights = Weights(spec.reference(cell.config, cell.bench).layout(model), r.seed, dev)
    bufs = weights.make()
    params = weights.tree(bufs)
    tcfg = TrainStepConfig(
        microbatches=int(mix["microbatches"]), remat=bool(mix["remat"]),
        adamw=AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                          weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"]),
        warmup_steps=int(opt["warmup_steps"]), total_steps=int(opt["total_steps"]))
    state = {"params": params, **adamw_init(params, tcfg.adamw)}
    step = make_train_step(cfg, tcfg)
    if step_hook is not None:
        step = step_hook(step)
    first = traffic.batches(mix, model["vocab_size"], r.seed, range(n_check), dev)
    pool = traffic.batches(mix, model["vocab_size"], r.seed,
                           range(n_check, n_check + int(mix["pool"])), dev)

    # the first steps, through the window's own call, with the check's readings
    index = {keystr(p): p for p in weights.leaves}
    losses = []
    for i, batch in enumerate(first):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        if i == 0:
            _sync(dev)
            t0 = time.perf_counter()
            norms = _norms(state["m"])
            r.program["grad"] = {index[k]: n / (1.0 - opt["b1"])
                                 for k, n in zip(_paths(state["m"]), norms)}
            r.check_s += time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    r.program["loss"] = [float(x) for x in losses]
    now = dict(zip(_paths(state["params"]), pytree.tree_leaves(state["params"])))
    r.program["change"] = {}
    for path in sorted(weights.leaves, key=lambda p: weights.where[p]):
        r.program["change"][path] = float(torch.linalg.vector_norm(
            now[keystr(path)].float() - weights.initial(path).float()))
    weights.forget()
    del now
    _sync(dev)
    r.check_s += time.perf_counter() - t0
    return SimpleNamespace(state=state, step=step, pool=pool, first=first, weights=weights,
                           steps=0)


def measure(r: Run, prog: SimpleNamespace, seconds: float, t_start: float) -> None:
    """The window: whole steps until the host clock passes ``seconds``."""
    dev = r.device
    if dev.type == "cuda":
        r.setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mix, step, pool = r.cell.traffic, prog.step, prog.pool
    spans = []
    collections = sum(g["collections"] for g in gc.get_stats())
    t_window = time.perf_counter()
    r.setup_s = t_window - t_start - r.check_s
    n = 0
    while True:
        a = time.perf_counter()
        prog.state, _ = step(prog.state, pool[n % len(pool)])
        spans.append(time.perf_counter() - a)
        n += 1
        if time.perf_counter() - t_window >= seconds:
            break
    _sync(dev)
    wall = time.perf_counter() - t_window
    prog.steps = n
    r.window = {"steps": n, "wall_s": wall, "host_s": sum(spans), "spans": spans,
                "tokens": n * int(mix["batch"]) * int(mix["seq_len"]),
                "gc_collections": sum(g["collections"] for g in gc.get_stats()) - collections}
    if dev.type == "cuda":
        r.window_peak = torch.cuda.max_memory_allocated(dev)


def traced(r: Run, prog: SimpleNamespace, trace_dir: Path | None = None) -> None:
    """More steps under the profiler: ``trace_steps`` of the mix recording
    the device alone (the device's numbers), then one recording the host's
    operations too (the idle gaps' names)."""
    def steps(k):
        for _ in range(k):
            with torch.profiler.record_function("bench.train_step"):
                prog.state, _ = prog.step(prog.state, prog.pool[prog.steps % len(prog.pool)])
            prog.steps += 1
        _sync(r.device)

    out = trace_dir or spec.ROOT / "build" / "bench"
    r.trace = tracing.profile(steps, int(r.cell.traffic["trace_steps"]),
                              out / f"{r.cell.name}.trace.json", host=False)
    r.trace.gaps = tracing.profile(steps, 1, out / f"{r.cell.name}.host.json", host=True).gaps


def free(r: Run, prog: SimpleNamespace) -> None:
    """Drop the program's state and step before the reference runs."""
    prog.state = prog.step = prog.pool = None
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()


def judge_reference(r: Run, prog: SimpleNamespace, precision: str = "fp32") -> dict:
    """The reference over the first steps from the same weights and batches;
    sets ``r.reference`` and ``r.numbers`` and returns the readings."""
    t0 = time.perf_counter()
    model, opt = r.cell.config["model"], r.cell.traffic["optimizer"]
    ref = spec.reference(r.cell.config, r.cell.bench)
    params = prog.weights.flat(prog.weights.make())
    r.reference = follow(ref, model, params, prog.first, opt, precision=precision,
                         initial=prog.weights.initial)
    prog.weights.forget()
    del params
    r.numbers = check.compare(r.program, r.reference)
    r.reference_s = time.perf_counter() - t0
    return r.reference


def run(cell: spec.Cell, seed: int, seconds: float, *, trace: bool, t_start: float,
        device: str = "cuda", step_hook=None, trace_dir: Path | None = None) -> Run:
    """Set-up, window, optional traced steps, then the reference and the
    comparison."""
    r = Run(cell=cell, seed=seed, device=torch.device(device))
    prog = start(r, step_hook=step_hook)
    measure(r, prog, seconds, t_start)
    if trace:
        traced(r, prog, trace_dir)
    free(r, prog)
    found = check.forbidden_modules(sys.modules)
    if found:
        raise SystemExit(f"the run loaded modules of JAX or of the JAX package: {found}")
    judge_reference(r, prog)
    return r


def context(r: Run, peaks: dict | None) -> SimpleNamespace:
    """What a metric reader gets."""
    return SimpleNamespace(
        cell=r.cell, config=r.cell.config, model=r.cell.config["model"],
        traffic=r.cell.traffic, window=r.window, setup_s=r.setup_s,
        window_peak=r.window_peak, trace=r.trace, reference=r.reference, peaks=peaks,
        roofline=lambda op: spec.roofline(op, r.cell.bench))
