"""Sharded training on ``torch.distributed``: the train state and batches
as DTensors placed by the spec factories, and the train step run under
the mesh context — what the JAX package gets from ``jax.jit``'s
``in_shardings`` and ``use_mesh`` (reference ``launch/train.py:97-112``).

The model code is the unsharded code: its ``shard()`` sites redistribute
the activations, DTensor propagates every aten op, the kernels' custom ops
run under ``dist.kernel_rules``, and plain tensors made inside the step
(positions, masks) count as replicated (``implicit_replication``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.sharding import (Mesh, MeshCtx, batch_axes, batch_pspecs, is_dtensor,
                                       placements, state_pspecs, tree_map_with_path, use_mesh)

__all__ = ["distribute_tree", "distribute_batch", "full_tree", "make_sharded_train_step",
           "mesh_ctx_for", "init_group", "parse_mesh", "spec_at"]


def spec_at(specs: Any, path: tuple) -> tuple:
    """The spec at ``path`` (dict keys and list indices) of a spec tree."""
    for k in path:
        specs = specs[k]
    return specs


def distribute_tree(tree: Any, specs: Any, mesh: Mesh, device_mesh) -> Any:
    """Every tensor leaf of ``tree`` (the full tensor, the same on every
    rank) as a DTensor placed by its spec.  Each rank keeps its own shard
    of what it holds: no communication (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, device_mesh, placements(spec_at(specs, path), mesh),
                                 src_data_rank=None)

    return tree_map_with_path(one, tree)


def full_tree(tree: Any) -> Any:
    """The DTensor leaves of ``tree`` gathered to full tensors on every
    rank (plain leaves pass through)."""
    from torch.distributed.tensor import DTensor

    return tree_map_with_path(
        lambda _p, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def distribute_batch(batch: dict, mesh: Mesh, device_mesh) -> dict:
    """A global batch (the same rows on every rank, as the seeded data
    pipeline gives them) as DTensors with the leading dim over the data
    axes."""
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    gb = next(iter(tensors.values())).shape[0]
    return distribute_tree(tensors, batch_pspecs(tensors, mesh, gb), mesh, device_mesh)


def mesh_ctx_for(mesh: Mesh, global_batch: int, *, seq_shard: bool = False) -> MeshCtx:
    """The cell's logical -> physical bindings: the batch axes for this
    global batch, and the model axis for the residual stream's sequence
    when activations are sequence-sharded."""
    return MeshCtx(mesh, batch_axes(mesh, global_batch), seq="model" if seq_shard else None)


def make_sharded_train_step(cfg, tcfg, mesh: Mesh, device_mesh, *, global_batch: int,
                            seq_shard: bool = False) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over a DTensor state
    (``distribute_tree(state, state_pspecs(...))``): the batch is
    distributed over the data axes and the unsharded ``make_train_step``
    runs under the mesh context.  Metrics come back as full tensors, the
    same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.step import make_train_step

    inner = make_train_step(cfg, tcfg)
    ctx = mesh_ctx_for(mesh, global_batch, seq_shard=seq_shard)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        dbatch = distribute_batch(batch, mesh, device_mesh)
        with use_mesh(ctx), implicit_replication():
            state, metrics = inner(state, dbatch)
        return state, {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}

    step.ctx = ctx
    return step


def parse_mesh(text: str) -> Mesh:
    """``"DxM"`` -> a ``("data", "model")`` mesh (``"D"``: data alone)."""
    dims = tuple(int(d) for d in text.lower().split("x"))
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2")
    return Mesh(dims, ("data", "model")[: len(dims)])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(device_type: str) -> tuple[int, int]:
    """Join the default process group: the launcher's (``torchrun`` sets
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``), or a world of one on a
    free local port.  ``nccl`` on the card (each rank on ``LOCAL_RANK``'s
    card), ``gloo`` on the CPU.  Returns (rank, world size)."""
    import os

    import torch.distributed as dist

    backend = "nccl" if device_type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                    rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()
