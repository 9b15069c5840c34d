"""``repro_torch.analysis`` — per-rank cost of a traced step and its
three-term roofline on an H100: the port of the JAX package's
``repro.analysis`` (HLO text there, the fx graph of ``make_fx`` here)."""
from .collectives import CollectiveStats, collective_bytes, collective_summary
from .fx_cost import ModuleCost, module_cost, peak_bytes, trace
from .roofline import H100_SXM, HardwareSpec, RooflineReport, roofline_report

__all__ = [
    "collective_bytes",
    "collective_summary",
    "CollectiveStats",
    "ModuleCost",
    "module_cost",
    "peak_bytes",
    "trace",
    "HardwareSpec",
    "H100_SXM",
    "RooflineReport",
    "roofline_report",
]
