"""repro_torch.hwperf — measured hardware performance: CPU topology discovery,
core-pinned executors, co-location interference measurement, and the
contention model that feeds measurements back into simulation and placement
(paper §3.1/Fig 3: pinned executors reach ~1.45x OS-scheduled FLOPS, and
concurrent ops interfere).

Layering: ``topology`` -> ``pinning`` -> ``colocate`` -> ``model``; the
model closes the loop into :mod:`repro_torch.core.simulate` (duration adjustment)
and :mod:`repro_torch.core.policies` (the ``cpf-contention`` placement policy).
On a CUDA card the executors are streams, each fed by one host thread:
pinning places those launcher threads on the host's cores, and the
co-location harness runs its workloads as kernel loops on two streams.
"""
from .colocate import (
    InterferenceMatrix,
    Workload,
    default_workloads,
    measure_interference,
)
from .model import (
    ContentionAwareCPF,
    ContentionModel,
    classify,
    install_contention_policy,
)
from .pinning import (
    NO_AFFINITY_ENV,
    AppliedPinning,
    PinningPlan,
    affinity_supported,
    pin_current_thread,
    pin_pool,
    plan_pinning,
)
from .topology import (
    CpuTopology,
    LogicalCpu,
    detect_topology,
    disjoint_core_sets,
    synthetic_topology,
)

__all__ = [
    "AppliedPinning",
    "ContentionAwareCPF",
    "ContentionModel",
    "CpuTopology",
    "InterferenceMatrix",
    "LogicalCpu",
    "NO_AFFINITY_ENV",
    "PinningPlan",
    "Workload",
    "affinity_supported",
    "classify",
    "default_workloads",
    "detect_topology",
    "disjoint_core_sets",
    "install_contention_policy",
    "measure_interference",
    "pin_current_thread",
    "pin_pool",
    "plan_pinning",
    "synthetic_topology",
]
