"""Analytic per-op cost model (the profiler's backend on a box without the
target hardware).

The paper measures per-op durations on KNL during the first iterations
(Section 4.2).  Where an op cannot be timed on the target hardware, the
profiler consumes a *roofline-based hardware model* instead:

    T(op, k) = alpha(k) + max( compute_term(op, k),
                               memory_term(op, k) )  + collective_term(op, k)

with a **granularity cap** `k_eff = clip(parallel_grains(op), 1, k)` modelling
the paper's Fig-2 observation that a small op stops scaling beyond the number
of efficiently-parallelizable work grains (GEMM [64,512]x[512,512] saturates
at ~8 KNL cores; a 32k elementwise at ~16).

Three models ship:

* ``KNL7250``  — Intel Xeon Phi 7250 (the paper's hardware), used by the
  paper-table reproduction benchmarks.
* ``TPUV5E``   — one TPU v5e chip as the "worker" of a pod-scale executor
  group, kept so planning on the same graph agrees with the JAX package.
* ``H100``     — one NVIDIA H100 SXM with its 132 SMs as the workers
  (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), the serving default of this
  package: a kernel launch is the per-op dispatch cost.

All times are **seconds**.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .graph import Graph, OpNode

__all__ = [
    "HardwareModel",
    "KNL7250",
    "TPUV5E",
    "H100",
    "op_time",
    "op_saturation_point",
    "graph_costs",
]


@dataclass(frozen=True)
class HardwareModel:
    name: str
    n_workers: int                # cores (KNL) / chips (pod)
    peak_flops: float             # per worker, achievable units/s at frac=1
    achievable_frac: float        # library efficiency ceiling (MKL / MXU)
    mem_bw_total: float           # shared memory bandwidth (B/s)
    mem_bw_per_worker: float      # max single-worker draw (B/s)
    dispatch_alpha: float         # fixed per-op launch / fork cost (s)
    team_beta: float              # extra barrier cost per log2(team size) (s)
    link_bw: float                # inter-worker interconnect (B/s); 0 = shared-mem
    grain_flops: float            # compute per efficiently-parallel grain
    grain_bytes: float            # bytes per efficiently-parallel grain
    workers_per_tile: int = 1     # workers sharing a cache tile (KNL: 2/L2)

    @property
    def peak_total(self) -> float:
        return self.n_workers * self.peak_flops * self.achievable_frac


# The paper's machine: 68 cores @1.4 GHz, AVX-512 (2 VPU): 32 fp32 FMA/cycle
# -> ~90 GF/s/core single precision peak; MKL large-GEMM efficiency ~55%.
# MCDRAM ~400+ GB/s total, ~12 GB/s single-core draw. OpenMP fork ~5 us.
# grain_flops calibrated so GEMM [64,512,512] (33.6 MF) saturates ~8 cores,
# grain_bytes so a 32k-element eltwise (~0.4 MB traffic) saturates ~16.
KNL7250 = HardwareModel(
    name="knl7250",
    n_workers=68,
    peak_flops=89.6e9,
    achievable_frac=0.55,
    mem_bw_total=420e9,
    mem_bw_per_worker=12e9,
    dispatch_alpha=5e-6,
    team_beta=2e-6,
    link_bw=0.0,
    grain_flops=4.2e6,
    grain_bytes=24e3,
    workers_per_tile=2,
)

# TPU v5e chip as a pod worker. grain_flops = one 128x128x512 MXU macro-tile;
# grain_bytes = one 128x512 bf16 block stream. dispatch_alpha models the
# per-op XLA launch + ICI barrier entry (~2 us).
TPUV5E = HardwareModel(
    name="tpuv5e",
    n_workers=256,
    peak_flops=197e12,
    achievable_frac=0.62,
    mem_bw_total=256 * 819e9,
    mem_bw_per_worker=819e9,
    dispatch_alpha=2e-6,
    team_beta=1e-6,
    link_bw=50e9,
    grain_flops=2 * 128 * 128 * 512,
    grain_bytes=128 * 512 * 2,
    workers_per_tile=1,
)


# One H100 SXM (published peaks: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3).
# Workers are the 132 SMs; peak_flops is one SM's share of the dense bf16
# rate.  One SM alone draws ~1/40 of the HBM rate (a few outstanding loads
# per SM cannot cover the latency), so memory-bound ops need a team of SMs
# to reach the roofline.  dispatch_alpha is one kernel launch from the host
# (~5 us); team_beta ~0: a wider grid costs no barrier.  grain_flops is one
# 128x128x64 tensor-core tile, grain_bytes one 128x64 bf16 tile.
H100 = HardwareModel(
    name="h100",
    n_workers=132,
    peak_flops=989e12 / 132,
    achievable_frac=0.6,
    mem_bw_total=3.35e12,
    mem_bw_per_worker=3.35e12 / 40,
    dispatch_alpha=5e-6,
    team_beta=1e-8,
    link_bw=0.0,
    grain_flops=2 * 128 * 128 * 64,
    grain_bytes=128 * 64 * 2,
    workers_per_tile=1,
)


def parallel_grains(hw: HardwareModel, op: OpNode) -> tuple[float, float]:
    """(compute grains, memory grains): how many workers each roofline term
    of this op can keep efficiently busy (the Fig-2 knee). The caps apply
    *per term* — extra memory parallelism cannot stretch a compute-bound op.

    GEMM shape cap: MKL parallelizes panels of the row dimension, so a
    tall-skinny [M=64, ...] GEMM stops scaling near M/8 threads no matter
    how many total flops it has — this is what makes the paper's Fig-2a
    [64,512]x[512,512] knee sit at 8 cores while a 16x-flops LSTM-large
    GEMM *still* saturates early (the whole premise of multi-executor
    scheduling).  Nodes advertise ``meta["rows"]``.
    """
    g_c = max(1.0, op.flops / hw.grain_flops) if op.flops else 1.0
    rows = op.meta.get("rows") if op.meta else None
    if rows is not None and op.kind in ("gemm", "conv"):
        g_c = min(g_c, max(1.0, rows / 8.0))
    g_m = max(1.0, op.bytes_total / hw.grain_bytes) if op.bytes_total else 1.0
    return g_c, g_m


def op_saturation_point(hw: HardwareModel, op: OpNode) -> int:
    """Smallest power-of-two team size at/beyond which adding workers stops
    reducing ``op_time`` (the knee of the paper's Fig 2)."""
    best_k, best_t = 1, op_time(hw, op, 1)
    k = 2
    while k <= hw.n_workers:
        t = op_time(hw, op, k)
        if t < best_t * (1.0 - 1e-3):
            best_k, best_t = k, t
        k *= 2
    return best_k


def op_time(hw: HardwareModel, op: OpNode, k: int, *, tp_collective: bool = True) -> float:
    """Modelled duration of ``op`` on a team of ``k`` workers.

    ``tp_collective``: when the op is *sharded* k ways on a linked fabric
    (TPU tensor-parallelism), its partial results must be combined — a ring
    all-reduce of the output, 2(k-1)/k * bytes_out per worker over ICI.
    Shared-memory CPUs (link_bw == 0) pay nothing (the paper's executors
    share MCDRAM).
    """
    if k < 1:
        raise ValueError(f"team size must be >= 1, got {k}")
    k = min(k, hw.n_workers)
    g_c, g_m = parallel_grains(hw, op)
    k_c = min(float(k), g_c)
    k_m = min(float(k), g_m)

    alpha = hw.dispatch_alpha + hw.team_beta * math.log2(k) if k > 1 else hw.dispatch_alpha

    compute = op.flops / (k_c * hw.peak_flops * hw.achievable_frac) if op.flops else 0.0

    bw = min(k_m * hw.mem_bw_per_worker, hw.mem_bw_total)
    memory = op.bytes_total / bw if op.bytes_total else 0.0

    comm = 0.0
    if tp_collective and k > 1 and hw.link_bw > 0 and op.bytes_out:
        comm = 2.0 * (k - 1) / k * op.bytes_out / hw.link_bw

    return alpha + max(compute, memory) + comm


def graph_costs(
    hw: HardwareModel, graph: Graph, team_size: int, *, tp_collective: bool = True
) -> dict[str, float]:
    """Per-op modelled cost table for a symmetric executor configuration."""
    return {
        n.name: op_time(hw, n, team_size, tp_collective=tp_collective)
        for n in graph.nodes
    }


def sequential_makespan(hw: HardwareModel, graph: Graph, team_size: int | None = None) -> float:
    """Makespan of the conventional one-executor interpreter (paper §2)."""
    k = team_size if team_size is not None else hw.n_workers
    return sum(op_time(hw, n, k) for n in graph.nodes)


def interference_multiplier(
    hw: HardwareModel,
    *,
    software_threads: int,
    pinned: bool,
) -> float:
    """Oversubscription / migration penalty for the TF-like baseline (Fig 3).

    The paper measures up to ~45% throughput loss with OS-managed threads and
    severe loss when #software threads > #cores (Eigen + OpenMP double pools).
    Modelled as a multiplicative slowdown on every op duration.
    """
    over = max(1.0, software_threads / hw.n_workers)
    migration = 1.0 if pinned else 1.45
    return over * migration
