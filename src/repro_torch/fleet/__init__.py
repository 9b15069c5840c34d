"""Fault-tolerant multi-replica serving fleet.

``Fleet`` supervises N worker processes (each one serve replica: a toy
engine, or the port's continuous or paged engine with its own CUDA context
and weights on the card), routes requests by prefix affinity + load,
detects crashed *and* wedged replicas via main-loop heartbeats, and replays
in-flight requests on healthy replicas (greedy decode of ``prompt +
emitted``).  See :mod:`repro_torch.fleet.supervisor` for the failure model
and :mod:`repro_torch.fleet.faults` for the seeded fault-injection harness.
Nothing here imports torch at module level: a toy worker spawns in ~0.1 s.
"""
from repro_torch.fleet.faults import FaultInjector, FaultSpec, corrupt_lease_release
from repro_torch.fleet.router import Router
from repro_torch.fleet.supervisor import Fleet, FleetConfig, FleetRequest
from repro_torch.fleet.worker import ToyEngine, build_engine, toy_next_token, worker_main

__all__ = [
    "Fleet", "FleetConfig", "FleetRequest", "Router",
    "FaultInjector", "FaultSpec", "corrupt_lease_release",
    "ToyEngine", "build_engine", "toy_next_token", "worker_main",
]
