"""CPU topology discovery: which logical CPUs exist, how they group into
physical cores, sockets, and NUMA nodes.

The paper pins each executor's OpenMP team to a contiguous block of KNL
cores (§3.1/Fig 3: pinned threads reach up to ~1.45x the FLOPS of
OS-scheduled ones).  Reproducing that requires knowing the machine's shape:

* two logical CPUs on one physical core (SMT siblings) share execution
  ports — putting two executors there is co-location, not parallelism;
* cores on different sockets share nothing but the interconnect — an
  executor team spanning sockets pays cross-socket cache traffic on every
  barrier.

:func:`detect_topology` reads the truth from ``/sys`` (restricted to the
CPUs this process may use, per ``os.sched_getaffinity``); where ``/sys`` is
absent (non-Linux, containers with a masked sysfs) it degrades to a flat
:func:`synthetic_topology` so every consumer — the pinning planner, the
co-location harness, the tests — works against one interface everywhere.

On a CUDA card the topology describes the host that feeds the streams:
each executor is a stream driven by one host thread, and those launcher
threads are what the pinning layer places on these CPUs.
"""
from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

__all__ = [
    "LogicalCpu",
    "CpuTopology",
    "detect_topology",
    "synthetic_topology",
    "disjoint_core_sets",
]


@dataclass(frozen=True)
class LogicalCpu:
    """One OS-schedulable CPU: the unit ``sched_setaffinity`` masks."""

    cpu: int      # logical id (the scheduler's number)
    core: int     # physical core id (SMT siblings share it)
    socket: int   # physical package id
    node: int     # NUMA node


@dataclass(frozen=True)
class CpuTopology:
    """The set of logical CPUs this process may run on, with their physical
    grouping.  ``source`` records provenance: ``"sys"`` (read from sysfs),
    ``"synthetic"`` (constructed), or ``"flat"`` (cpu count only — no
    core/socket structure was discoverable)."""

    cpus: tuple[LogicalCpu, ...]
    source: str = "synthetic"

    @property
    def n_cpus(self) -> int:
        return len(self.cpus)

    @property
    def sockets(self) -> tuple[int, ...]:
        return tuple(sorted({c.socket for c in self.cpus}))

    @property
    def nodes(self) -> tuple[int, ...]:
        return tuple(sorted({c.node for c in self.cpus}))

    @property
    def smt(self) -> bool:
        """Whether any physical core carries more than one logical CPU."""
        return any(len(g) > 1 for g in self.physical_cores())

    def physical_cores(self) -> list[tuple[int, ...]]:
        """Logical CPU ids grouped by (socket, core) — SMT siblings land in
        one group.  Stable order: by socket, then core id, then cpu id, so
        two detections of one machine enumerate identically."""
        groups: dict[tuple[int, int], list[int]] = {}
        for c in self.cpus:
            groups.setdefault((c.socket, c.core), []).append(c.cpu)
        return [tuple(sorted(groups[k])) for k in sorted(groups)]

    def cpus_of_socket(self, socket: int) -> tuple[int, ...]:
        return tuple(sorted(c.cpu for c in self.cpus if c.socket == socket))

    def smt_siblings(self, cpu: int) -> tuple[int, ...]:
        """All logical CPUs (including ``cpu``) on ``cpu``'s physical core."""
        me = next((c for c in self.cpus if c.cpu == cpu), None)
        if me is None:
            raise ValueError(f"cpu {cpu} is not in this topology")
        return tuple(sorted(
            c.cpu for c in self.cpus
            if c.socket == me.socket and c.core == me.core))

    def describe(self) -> str:
        cores = self.physical_cores()
        return (f"CpuTopology({self.n_cpus} cpus, {len(cores)} cores, "
                f"{len(self.sockets)} socket(s), {len(self.nodes)} node(s), "
                f"smt={'on' if self.smt else 'off'}, source={self.source})")


def synthetic_topology(n_cpus: int, *, sockets: int = 1, smt: int = 1,
                       source: str = "synthetic") -> CpuTopology:
    """A constructed topology: ``n_cpus`` logical CPUs over
    ``n_cpus // smt`` physical cores spread evenly across ``sockets``.

    Logical ids follow the Linux enumeration convention — first one CPU per
    core (0..cores-1), then the SMT siblings (cores..2*cores-1) — so tests
    written against synthetic shapes transfer to real machines.
    """
    if n_cpus < 1:
        raise ValueError(f"need >= 1 cpu, got {n_cpus}")
    if sockets < 1 or smt < 1:
        raise ValueError(f"need sockets >= 1 and smt >= 1, got {sockets}/{smt}")
    n_cores = max(1, n_cpus // smt)
    cpus = []
    for i in range(n_cpus):
        core = i % n_cores
        socket = core * sockets // n_cores
        cpus.append(LogicalCpu(cpu=i, core=core, socket=socket, node=socket))
    return CpuTopology(cpus=tuple(cpus), source=source)


def _read_int(path: str) -> int | None:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _cpu_node(cpu_dir: str) -> int | None:
    """NUMA node of one cpu: the ``nodeN`` entry linked into its sysfs dir."""
    for p in glob.glob(os.path.join(cpu_dir, "node*")):
        m = re.fullmatch(r"node(\d+)", os.path.basename(p))
        if m:
            return int(m.group(1))
    return None


def _usable_cpus() -> list[int]:
    """The logical CPUs this process may be scheduled on: the affinity mask
    where the OS exposes one (a cgroup cpuset shrinks it below the machine
    count — planning against unusable CPUs would make every pin fail)."""
    if hasattr(os, "sched_getaffinity"):
        try:
            return sorted(os.sched_getaffinity(0))
        except OSError:  # pragma: no cover - exotic kernels
            pass
    return list(range(os.cpu_count() or 1))


def detect_topology(sysfs: str = "/sys") -> CpuTopology:
    """The running machine's topology, restricted to usable CPUs.

    Reads ``{sysfs}/devices/system/cpu/cpuN/topology/`` per CPU; any CPU
    whose files are unreadable (masked sysfs, non-Linux) drops the whole
    detection to a flat :func:`synthetic_topology` over the usable count —
    a *partial* sysfs read must not fabricate an asymmetric machine.
    ``sysfs`` is injectable so tests exercise the parser against a fake
    tree.
    """
    usable = _usable_cpus()
    cpus: list[LogicalCpu] = []
    for cpu in usable:
        topo_dir = os.path.join(sysfs, "devices", "system", "cpu", f"cpu{cpu}")
        core = _read_int(os.path.join(topo_dir, "topology", "core_id"))
        socket = _read_int(
            os.path.join(topo_dir, "topology", "physical_package_id"))
        if core is None or socket is None:
            return synthetic_topology(len(usable), source="flat")
        node = _cpu_node(topo_dir)
        cpus.append(LogicalCpu(
            cpu=cpu, core=core, socket=max(0, socket),
            node=node if node is not None else max(0, socket)))
    if not cpus:
        return synthetic_topology(1, source="flat")
    return CpuTopology(cpus=tuple(cpus), source="sys")


def disjoint_core_sets(
    topology: CpuTopology,
    n_sets: int,
    *,
    cpus_per_set: int | None = None,
) -> list[tuple[int, ...]]:
    """Partition the topology's CPUs into ``n_sets`` core sets for pinned
    executors.

    Placement policy (the paper's §3.1 pinning, socket-aware):

    * whole physical cores go to one set — SMT siblings are never split
      across executors (they would interfere by construction);
    * sets fill socket by socket, so each executor's CPUs stay on one
      socket whenever ``cpus_per_set`` fits (no cross-socket barriers);
    * when there are fewer CPUs than sets the sets are **not** disjoint —
      executors round-robin over single CPUs (two executors time-share a
      CPU rather than crash; the pinning layer reports ``disjoint=False``).

    ``cpus_per_set`` defaults to an even split (``n_cpus // n_sets``,
    floor 1).  Leftover CPUs stay unassigned, mirroring the paper's idle
    leftover cores (§4.2).
    """
    if n_sets < 1:
        raise ValueError(f"need >= 1 set, got {n_sets}")
    # socket-major, whole-core-major CPU order: consuming this list in
    # chunks gives each set contiguous cores on one socket
    ordered: list[int] = []
    for socket in topology.sockets:
        for group in topology.physical_cores():
            if all(c in topology.cpus_of_socket(socket) for c in group):
                ordered.extend(group)
    if not ordered:  # pragma: no cover - empty topology is rejected upstream
        ordered = [c.cpu for c in topology.cpus]
    if n_sets > len(ordered):
        # oversubscribed: round-robin single CPUs (overlapping sets)
        return [(ordered[i % len(ordered)],) for i in range(n_sets)]
    size = cpus_per_set if cpus_per_set is not None else max(1, len(ordered) // n_sets)
    size = max(1, min(size, len(ordered) // n_sets))
    return [tuple(ordered[i * size:(i + 1) * size]) for i in range(n_sets)]
