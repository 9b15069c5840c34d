"""The Graphi profiler (paper §4.2).

Two jobs:
  1. **Configuration search** — enumerate symmetric executor configurations
     (N executors × K workers each, N·K = available workers) and pick the one
     with minimal makespan.
  2. **Per-op cost table** — modelled via the hardware cost model, or
     *measured* by timing real node ``fn`` executions (CPU ops, or CUDA ops
     with the device synchronised around each timed call).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from .cost_model import HardwareModel, graph_costs
from .graph import Graph
from .simulate import SimConfig, simulate

__all__ = ["ProfileResult", "enumerate_symmetric_configs", "profile", "measure_op_costs",
           "sync_cuda"]


@dataclass
class ProfileResult:
    best_n_executors: int
    best_team_size: int
    best_makespan: float
    # (n_executors, team_size) -> makespan
    config_makespans: dict[tuple[int, int], float]
    op_costs: dict[str, float] = field(repr=False, default_factory=dict)

    @property
    def best_config(self) -> tuple[int, int]:
        return self.best_n_executors, self.best_team_size


def enumerate_symmetric_configs(n_workers: int, max_executors: int | None = None) -> list[tuple[int, int]]:
    """Symmetric (n_executors, team_size) configs with n_executors a power of
    two and team_size = floor(n_workers / n_executors) (paper §4.2 / §7.3:
    64 usable KNL cores -> 1x64, 2x32, ..., 32x2; leftover cores stay idle)."""
    out: list[tuple[int, int]] = []
    n = 1
    while n <= n_workers and (max_executors is None or n <= max_executors):
        team = n_workers // n
        if team >= 1:
            out.append((n, team))
        n *= 2
    return out


def profile(
    graph: Graph,
    hw: HardwareModel,
    *,
    n_workers: int,
    policy: str = "cpf",
    max_executors: int | None = None,
    extra_configs: list[tuple[int, int]] | None = None,
    measured_costs: Callable[[int], Mapping[str, float]] | None = None,
    seed: int = 0,
) -> ProfileResult:
    """Search symmetric configs; ``measured_costs(team_size)`` optionally
    overrides the analytic cost table (the paper's first-iterations timing).

    ``max_executors`` bounds the sweep (serving wants a cap so one request
    stream cannot claim the whole machine); ``extra_configs`` are explicit
    additions and are *not* re-filtered by the bound.
    """
    configs = enumerate_symmetric_configs(n_workers, max_executors=max_executors)
    if extra_configs:
        configs = sorted(set(configs) | set(extra_configs))
    results: dict[tuple[int, int], float] = {}
    best: tuple[float, int, int] | None = None
    best_costs: dict[str, float] = {}
    for n_exec, team in configs:
        if measured_costs is not None:
            costs = dict(measured_costs(team))
        else:
            costs = graph_costs(hw, graph, team)
        cfg = SimConfig(n_executors=n_exec, team_size=team, policy=policy)
        res = simulate(graph, hw, cfg, costs=costs, seed=seed)
        results[(n_exec, team)] = res.makespan
        if best is None or res.makespan < best[0]:
            best = (res.makespan, n_exec, team)
            best_costs = costs
    if best is None:
        raise RuntimeError("profile enumerated no executor configurations")
    return ProfileResult(
        best_n_executors=best[1],
        best_team_size=best[2],
        best_makespan=best[0],
        config_makespans=results,
        op_costs=best_costs,
    )


def sync_cuda(value: Any) -> Any:
    """Wait for the device when ``value`` holds a CUDA tensor: PyTorch
    returns before the card finishes, so an unsynchronised host clock
    would time the enqueue, not the op."""
    for leaf in pytree.tree_leaves(value):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return value


def measure_op_costs(
    graph: Graph,
    inputs: Mapping[str, Any] | None = None,
    *,
    warmup: int = 1,
    iters: int = 3,
    block: Callable[[Any], Any] | None = None,
) -> dict[str, float]:
    """Measured per-op durations by executing node ``fn``s (paper's profiler
    records start/end over the first few iterations and averages).

    ``block``: result-synchronizer (default :func:`sync_cuda`) so
    asynchronous device dispatch does not distort timings.
    """
    sync = block or sync_cuda
    outs = graph.execute(inputs)  # warm caches / compile
    costs: dict[str, float] = {}
    for n in graph.topo_order():
        node = graph[n]
        if node.fn is None:
            costs[n] = 0.0
            continue
        args = [outs[d] for d in node.deps]
        for _ in range(warmup):
            sync(node.fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            sync(node.fn(*args))
        costs[n] = (time.perf_counter() - t0) / iters
    return costs
