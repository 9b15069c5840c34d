"""Three-term roofline of one rank's step — the port of the JAX package's
``analysis/roofline.py`` with an H100 spec.

    compute    = flops            / (peak FLOP/s per card)
    memory     = bytes            / (HBM rate per card)
    collective = collective_bytes / (NVLink rate per card, one direction)

All numerators are **per-rank** quantities from the rank's traced program
(``analysis.fx_cost``: the fx graph ``make_fx`` records, every loop
unrolled, the kernels' ops counted by their own formulas).

The dominant term estimates step time at perfect overlap; usefulness is
judged by MODEL_FLOPS / (flops x ranks) (how much traced compute is
6ND-useful) and by the roofline fraction compute / max(all) (MFU bound at
that schedule).

``H100_SXM``: NVIDIA's published H100 SXM5 figures (the H100 datasheet):
989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM3, NVLink 4 at 900 GB/s per card in both directions
together (450 GB/s each way), 80 GB of HBM.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .fx_cost import ModuleCost

__all__ = ["HardwareSpec", "H100_SXM", "RooflineReport", "roofline_report"]


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # per card, bf16
    hbm_bw: float            # per card, B/s
    link_bw: float           # per card, B/s one way (NVLink)
    hbm_bytes: float         # per card capacity
    peak_flops_f32: float = 0.0   # per card, f32 outside the tensor cores

    def describe(self) -> str:
        return (
            f"{self.name}: {self.peak_flops/1e12:.0f} TF/s bf16, "
            f"{self.hbm_bw/1e9:.0f} GB/s HBM, {self.link_bw/1e9:.0f} GB/s NVLink"
        )


H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
    peak_flops_f32=67e12,
)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # per-rank numerators
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: dict = field(default_factory=dict)
    # terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    # usefulness
    model_flops_total: float = 0.0
    useful_ratio: float = 0.0        # MODEL_FLOPS / (flops * ranks)
    roofline_fraction: float = 0.0   # compute_s / max(terms) — MFU upper bound
    # memory fit
    bytes_per_device: float = 0.0
    fits_hbm: bool = True
    dominant: str = "compute"
    note: str = ""

    def step_time_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def mfu_bound(self, hw: "HardwareSpec | None" = None) -> float:
        """Model-flops utilization at the roofline bound (what a perfect
        runtime would achieve with this traced program)."""
        hw = hw or H100_SXM
        t = self.step_time_bound()
        if t <= 0 or not self.n_chips:
            return 0.0
        return self.model_flops_total / (t * self.n_chips * hw.peak_flops)

    def row(self) -> str:
        return (
            f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
            f"c={self.compute_s*1e3:9.3f}ms m={self.memory_s*1e3:9.3f}ms "
            f"x={self.collective_s*1e3:9.3f}ms dom={self.dominant:10s} "
            f"useful={self.useful_ratio:6.3f} frac={self.roofline_fraction:5.3f}"
        )


def roofline_report(
    *,
    arch: str,
    shape: str,
    mesh_desc: str,
    n_chips: int,
    cost: ModuleCost,
    model_flops_total: float,
    bytes_per_device: float = 0.0,
    hw: HardwareSpec = H100_SXM,
) -> RooflineReport:
    """The report from a rank's :class:`ModuleCost` (the reference reads
    the same numerators from its HLO text)."""
    mc = cost
    compute_s = mc.flops / hw.peak_flops
    memory_s = mc.bytes / hw.hbm_bw
    collective_s = mc.collective_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    total = mc.flops * n_chips
    rep = RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        n_chips=n_chips,
        hlo_flops=mc.flops,
        hlo_bytes=mc.bytes,
        collective_bytes=mc.collective_bytes,
        collectives={k: v for k, v in mc.collectives.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops_total=model_flops_total,
        useful_ratio=model_flops_total / total if total else 0.0,
        roofline_fraction=compute_s / max(max(terms.values()), 1e-30),
        bytes_per_device=bytes_per_device,
        fits_hbm=bytes_per_device <= hw.hbm_bytes if bytes_per_device else True,
        dominant=dominant,
    )
    if mc.unknown_ops:
        rep.note = f"{mc.unknown_ops} op(s) without a cost formula (counted as elementwise)"
    return rep
