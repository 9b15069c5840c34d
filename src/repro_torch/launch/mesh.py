"""Production meshes of H100 cards.

``make_production_mesh`` describes the mesh (a
:class:`repro_torch.dist.sharding.Mesh`: axis names, shape, rank ids); it
touches no process group, so a process that holds one rank of it — or none
— builds it the same way (``Mesh.to_device_mesh`` binds it to the current
group).

Topology: a DGX H100 node holds 8 H100 SXM cards joined all to all by
NVLink 4 / NVSwitch (900 GB/s per card, both directions together); nodes
talk over InfiniBand (one 400 Gb/s NIC per card).  ``("data", "model")`` =
(32, 8) puts the ``model`` axis inside one node, so the tensor-parallel
collectives stay on NVLink, and runs ``data`` across 32 nodes (256 cards,
a DGX SuperPOD's scalable unit of 32 nodes).  The multi-pod mesh adds a
``pod`` axis of 2 such units, which crosses the inter-pod network and only
carries gradient all-reduces.  These numbers are NVIDIA's published DGX
H100 / SuperPOD reference architecture; nothing in the sharding rules
depends on the pod count.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh

__all__ = ["make_production_mesh", "make_mesh", "describe_mesh", "NODE_CARDS", "POD_NODES"]

NODE_CARDS = 8       # H100 SXM cards per DGX H100 node (the NVLink domain)
POD_NODES = 32       # nodes per SuperPOD scalable unit


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2) -> Mesh:
    shape = (n_pods, POD_NODES, NODE_CARDS) if multi_pod else (POD_NODES, NODE_CARDS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """General constructor for experiments (other splits of the same cards)."""
    return Mesh(shape, axes)


def describe_mesh(mesh) -> str:
    return " x ".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
