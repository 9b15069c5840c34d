"""``repro_torch.dist`` — the sharding / collectives layer, the port of the
JAX package's ``repro.dist`` on ``torch.distributed`` and DTensor.

Graphi's premise is that independent ops pay off only when they run on
*disjoint* resource partitions; on a mesh of ranks the partitioning layer
IS the interference-isolation mechanism.  This package is that layer:

* :mod:`repro_torch.dist.sharding` — the :class:`Mesh` description, the
  logical-axis mesh context (``MeshCtx`` / ``use_mesh`` / ``shard``) and the
  spec factories every launch path places its tensors by
  (``param_pspecs``, ``state_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
  ``batch_axes``), with ``placements`` turning a spec into DTensor
  placements.
* :mod:`repro_torch.dist.kernel_rules` — how the kernels' custom ops run on
  DTensors (``local_map`` with each shard's offsets), the sharded decode's
  log-sum-exp merge included.
* :mod:`repro_torch.dist.train` — the train state and batches as DTensors,
  and the sharded train step.
* :mod:`repro_torch.dist.overlap` — compute/communication-overlapped
  collective matmuls (``ring_allgather_matmul`` / ``ring_reducescatter_matmul``).
* :mod:`repro_torch.dist.compress` — gradient compression
  (``compressed_psum``) with error feedback for the ``pod`` axis.
* :mod:`repro_torch.dist.executor_mesh` — the bridge from the scheduler's
  barrier slots to disjoint executor sub-meshes.

Importing the package imports none of ``torch.distributed``'s tensor
machinery: the modules that need it import it where they use it.
"""
from . import compress, executor_mesh, overlap, sharding
from .executor_mesh import (
    ExecutorGroup,
    ExecutorMeshPlan,
    executor_groups,
    executor_stacked_mesh,
    plan_from_schedule,
)
from .sharding import (
    Mesh,
    MeshCtx,
    batch_axes,
    batch_pspecs,
    cache_pspecs,
    mesh_context,
    param_pspecs,
    placements,
    shard,
    state_pspecs,
    use_mesh,
)

__all__ = [
    "compress",
    "executor_mesh",
    "overlap",
    "sharding",
    "ExecutorGroup",
    "ExecutorMeshPlan",
    "executor_groups",
    "executor_stacked_mesh",
    "plan_from_schedule",
    "Mesh",
    "MeshCtx",
    "batch_axes",
    "batch_pspecs",
    "cache_pspecs",
    "mesh_context",
    "param_pspecs",
    "placements",
    "shard",
    "state_pspecs",
    "use_mesh",
]
