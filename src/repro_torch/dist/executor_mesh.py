"""Slot → executor sub-mesh bridge — the port of the JAX package's
``dist/executor_mesh.py``.

The paper's executors are disjoint worker teams; on a mesh of ranks they
are disjoint *sub-meshes*.  This module maps the scheduler's static plan
(``core.scheduler.slot_assignment`` — barrier-separated groups of mutually
independent ops, each at most ``n_executors`` wide) onto rank placement,
two ways:

* **disjoint sub-meshes** (:func:`executor_groups` / :func:`plan_from_schedule`)
  — each slot lane owns a contiguous slice of one mesh axis; independent ops
  of a slot run simultaneously with zero resource overlap (the paper's
  interference-free condition).
* **stacked execution** (:func:`executor_stacked_mesh` / :func:`lane_pspec`)
  — the lanes of a slot are stacked on a leading tensor axis and that axis
  is sharded over an ``executor`` mesh axis: one SPMD program, spatially
  multiplexed.

Meshes are :class:`repro_torch.dist.sharding.Mesh` descriptions; a
sub-mesh keeps the parent's rank ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.core.graph import Graph
from repro_torch.core.scheduler import Schedule, slot_assignment
from repro_torch.dist.sharding import Mesh

__all__ = [
    "ExecutorGroup",
    "ExecutorMeshPlan",
    "pick_executor_axis",
    "executor_groups",
    "executor_stacked_mesh",
    "lane_pspec",
    "plan_from_schedule",
]


@dataclass(frozen=True)
class ExecutorGroup:
    """One executor: a disjoint sub-mesh slice of the parent mesh."""

    index: int
    mesh: Mesh
    device_ids: tuple[int, ...]


@dataclass(frozen=True)
class ExecutorMeshPlan:
    """A frozen Graphi schedule bound to rank placement.

    ``slots[s]`` lists the ops of barrier slot ``s``; op at lane ``k`` runs
    on ``groups[k]``; ``placement`` is the flattened op -> group index map.
    """

    groups: tuple[ExecutorGroup, ...]
    slots: tuple[tuple[str, ...], ...]
    placement: dict[str, int]

    @property
    def n_executors(self) -> int:
        return len(self.groups)

    def group_of(self, op: str) -> ExecutorGroup:
        return self.groups[self.placement[op]]


def pick_executor_axis(mesh: Mesh, n_executors: int) -> str:
    """The axis executor groups slice: ``model`` when it divides (TP stays
    intra-group, the paper's team locality), else the largest divisible axis."""
    names = tuple(mesh.axis_names)
    if "model" in names and mesh.shape["model"] % n_executors == 0:
        return "model"
    cands = [a for a in names if mesh.shape[a] % n_executors == 0]
    if not cands:
        raise ValueError(
            f"no mesh axis of {dict(mesh.shape)} divisible by {n_executors} executors"
        )
    return max(cands, key=lambda a: mesh.shape[a])


def _resolve_axis(mesh: Mesh, n_executors: int, axis: str | None) -> tuple[str, int]:
    """(axis name, its index) for an executor split, divisibility-checked."""
    ax = axis or pick_executor_axis(mesh, n_executors)
    if mesh.shape[ax] % n_executors != 0:
        raise ValueError(f"axis {ax}={mesh.shape[ax]} not divisible by {n_executors}")
    return ax, tuple(mesh.axis_names).index(ax)


def executor_groups(
    mesh: Mesh, n_executors: int, *, axis: str | None = None
) -> list[ExecutorGroup]:
    """Split ``mesh`` into ``n_executors`` disjoint sub-meshes along ``axis``.

    Group ``g`` keeps the full extent of every other axis and a contiguous
    ``1/n_executors`` slice of ``axis``, so the union of groups is exactly
    the parent mesh and intersections are empty.
    """
    ax, i = _resolve_axis(mesh, n_executors, axis)
    per = mesh.shape[ax] // n_executors
    devs = mesh.devices
    groups = []
    for g in range(n_executors):
        sl: list[Any] = [slice(None)] * devs.ndim
        sl[i] = slice(g * per, (g + 1) * per)
        sub = devs[tuple(sl)]
        groups.append(
            ExecutorGroup(
                index=g,
                mesh=Mesh(sub.shape, mesh.axis_names, devices=sub),
                device_ids=tuple(int(d) for d in sub.flat),
            )
        )
    return groups


def executor_stacked_mesh(
    mesh: Mesh, n_executors: int, *, axis: str | None = None
) -> Mesh:
    """Reshape ``axis`` (size A) into ``("executor", axis)`` = (E, A/E): the
    mesh for slot-stacked execution, where a slot's lanes live on a leading
    tensor axis sharded over ``executor`` (one program, disjoint partitions)."""
    ax, i = _resolve_axis(mesh, n_executors, axis)
    devs = mesh.devices
    new_shape = (
        devs.shape[:i] + (n_executors, devs.shape[i] // n_executors) + devs.shape[i + 1:]
    )
    names = tuple(mesh.axis_names[:i]) + ("executor", ax) + tuple(mesh.axis_names[i + 1:])
    return Mesh(new_shape, names, devices=devs.reshape(new_shape))


def lane_pspec(rank: int) -> tuple:
    """Spec for a slot-stacked tensor [n_lanes, ...]: lanes over ``executor``."""
    return ("executor",) + (None,) * max(0, rank - 1)


def plan_from_schedule(
    graph: Graph, schedule: Schedule, mesh: Mesh, *, axis: str | None = None
) -> ExecutorMeshPlan:
    """Bind a :class:`Schedule` to ranks: derive the barrier slots and give
    lane ``k`` of every slot the ``k``-th executor sub-mesh.

    Lane order within a slot follows the schedule's start order (how
    ``slot_assignment`` emits it), so at most ``schedule.n_executors`` lanes
    exist and ops sharing a slot never share a group — the static-plan
    analogue of the paper's one-op-per-executor invariant.
    """
    slots = slot_assignment(graph, schedule)
    groups = executor_groups(mesh, schedule.n_executors, axis=axis)
    placement: dict[str, int] = {}
    for slot in slots:
        for lane, op in enumerate(slot):
            placement[op] = lane
    return ExecutorMeshPlan(
        groups=tuple(groups),
        slots=tuple(tuple(s) for s in slots),
        placement=placement,
    )
