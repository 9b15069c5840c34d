"""Graphi on PyTorch and CUDA: capture a model into an op graph, profile it,
plan it critical-path-first, and run the plan on executors that are CUDA
streams — the port of the JAX package ``repro`` to one NVIDIA H100.

Public surface (lazily resolved, so ``import repro_torch`` stays cheap)::

    import repro_torch
    rt = repro_torch.Runtime()                 # on the card; device="cpu" for tests
    exe = rt.compile(fn, *example_args)        # capture -> plan -> run on leases
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(...), paged=PagedConfig(...))
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "compile": "repro_torch.api",
    "Executable": "repro_torch.api",
    "serve_engine": "repro_torch.api",
    "Runtime": "repro_torch.runtime",
    "default_runtime": "repro_torch.runtime",
    "set_default_runtime": "repro_torch.runtime",
    "CalibrationStore": "repro_torch.runtime",
    "ExecutorLease": "repro_torch.runtime",
    "graph_signature": "repro_torch.runtime",
    "AdmissionRejected": "repro_torch.runtime",
    "DeadlineExceeded": "repro_torch.core.engine",
    "capture": "repro_torch.core.capture",
    "CapturedGraph": "repro_torch.core.capture",
    "Graph": "repro_torch.core.graph",
    "OpNode": "repro_torch.core.graph",
    "GraphValidationError": "repro_torch.core.graph",
    "HardwareModel": "repro_torch.core.cost_model",
    "H100": "repro_torch.core.cost_model",
    "KNL7250": "repro_torch.core.cost_model",
    "TPUV5E": "repro_torch.core.cost_model",
    "ProfileResult": "repro_torch.core.profiler",
    "Schedule": "repro_torch.core.scheduler",
    "SimConfig": "repro_torch.core.simulate",
    "SimResult": "repro_torch.core.simulate",
    "simulate": "repro_torch.core.simulate",
    "ExecutorPool": "repro_torch.core.engine",
    "HostScheduler": "repro_torch.core.engine",
    "HostRunResult": "repro_torch.core.engine",
    "StaticHostPlan": "repro_torch.core.static_host",
    "compile_host_plan": "repro_torch.core.static_host",
    "PagedConfig": "repro_torch.serve.paged",
    "PagedEngine": "repro_torch.serve.paged",
    "Request": "repro_torch.serve.engine",
    "ServeConfig": "repro_torch.serve.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
