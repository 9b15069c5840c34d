"""Logical-axis sharding: a mesh description, the mesh context, and the
partition-spec factories — the port of the JAX package's
``dist/sharding.py``, entry for entry.

The models layer speaks *logical* axes ("batch", "seq", "model",
"attn_seq"); this module owns the mapping onto physical mesh axes.
Everything degrades to a no-op without an active mesh, so the same model
code runs single-device tests and a production mesh's rank share unchanged.

* :class:`Mesh` describes a mesh (axis names, shape, an array of rank ids)
  whether or not those ranks exist in this process, as a production mesh
  must; :meth:`Mesh.to_device_mesh` turns it into a
  ``torch.distributed.device_mesh.DeviceMesh`` over the current group.
* A spec is a tuple with one entry per tensor dimension (None, one mesh
  axis name, or a tuple of them), as ``jax.sharding.PartitionSpec`` is;
  :func:`placements` turns it into DTensor placements.
* ``shard(x, *logical)`` redistributes a DTensor to the resolved placements
  and silently **drops** any logical axis whose mesh extent does not divide
  the dimension or whose mesh axes an earlier dimension consumed.  On a
  plain tensor, or without a mesh, it returns ``x``.
* ``param_pspecs(..., fsdp=True)`` adds ZeRO-3: on top of the
  tensor-parallel rules, the largest still-replicated dimension of every
  leaf is sharded over the ``data`` axis (moments included through
  ``state_pspecs``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Iterator, Sequence

import numpy as np
import torch

__all__ = [
    "Mesh",
    "MeshCtx",
    "use_mesh",
    "mesh_context",
    "shard",
    "placements",
    "is_dtensor",
    "batch_axes",
    "param_pspecs",
    "state_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "tree_map_with_path",
]

# mesh axes that never carry the batch dimension (tensor/executor parallel)
_NON_BATCH_AXES = frozenset({"model", "executor"})


class Mesh:
    """A named mesh of ranks: ``axis_names``, ``shape`` (axis -> extent, in
    axis order, as a JAX mesh's) and ``devices`` (a numpy array of rank ids
    with that shape; ``arange`` by default).  Nothing here needs the ranks
    to exist: a production mesh of 256 ranks is described in a process that
    holds one of them, or none."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Any = None):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} does not fit axis names {names}")
        ids = (np.arange(math.prod(shape)) if devices is None
               else np.asarray(devices, dtype=np.int64))
        self.devices = ids.reshape(shape)
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self._device_meshes: dict[str, Any] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"

    def to_device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of these ranks over the current default process
        group (cached per group: building one creates a sub-group per axis)."""
        import torch.distributed as dist

        group = dist.distributed_c10d._get_default_group()
        cached = self._device_meshes.get(device_type)
        if cached is not None and cached[0] is group:
            return cached[1]
        from torch.distributed.device_mesh import DeviceMesh

        # holding the group keeps a new one from reusing its identity
        dm = DeviceMesh(device_type, torch.as_tensor(self.devices),
                        mesh_dim_names=self.axis_names)
        self._device_meshes[device_type] = (group, dm)
        return dm


def batch_axes(mesh: Any, global_batch: int) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over: every non-model axis, in
    mesh order, as long as the running product still divides the batch
    (``long_500k``'s B=1 legitimately returns ``()``)."""
    out: list[str] = []
    prod = 1
    for a in mesh.axis_names:
        if a in _NON_BATCH_AXES:
            continue
        size = mesh.shape[a]
        if size > 1 and global_batch % (prod * size) == 0:
            out.append(a)
            prod *= size
    return tuple(out)


def _resolve(
    logical: str | None, mesh: Any, batch: tuple[str, ...], seq: str | None
) -> tuple[str, ...]:
    """Logical axis name -> physical mesh axes (possibly empty)."""
    if logical is None:
        return ()
    names = tuple(mesh.axis_names)
    if logical == "batch":
        return tuple(a for a in batch if a in names)
    if logical == "seq":
        return (seq,) if seq and seq in names else ()
    if logical in ("model", "attn_seq"):
        # attn_seq: independent q rows over the model axis (the MQA path)
        return ("model",) if "model" in names else ()
    if logical in names:
        return (logical,)
    return ()


def _entry(axes: Sequence[str]) -> Any:
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _build_spec(
    shape: Sequence[int],
    logical: Sequence[str | None],
    mesh: Any,
    batch: tuple[str, ...] = (),
    seq: str | None = None,
) -> tuple:
    """Resolve a logical spec against concrete dims: per-dim, keep the
    greedy prefix of mesh axes whose cumulative extent divides the dim and
    that no earlier dim consumed."""
    used: set[str] = set()
    entries: list[Any] = []
    for dim, l in zip(shape, logical):
        keep: list[str] = []
        prod = 1
        for a in _resolve(l, mesh, batch, seq):
            size = mesh.shape[a]
            if a in used or size <= 0 or dim % (prod * size) != 0:
                break
            keep.append(a)
            prod *= size
        used.update(keep)
        entries.append(_entry(keep))
    return tuple(entries)


def _axes_of(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[Any], mesh: Any) -> tuple:
    """DTensor placements (one per mesh axis, in mesh order) for a spec:
    ``Shard(d)`` on every mesh axis that tensor dim ``d``'s entry names,
    ``Replicate()`` on the rest.  A dim sharded over several axes splits in
    mesh order, as the spec's tuple lists them."""
    from torch.distributed.tensor import Replicate, Shard

    out: list[Any] = [Replicate()] * len(mesh.axis_names)
    for d, e in enumerate(spec):
        for a in _axes_of(e):
            out[list(mesh.axis_names).index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class MeshCtx:
    """An activated mesh plus the logical->physical axis bindings for one
    cell: which axes carry the batch, and whether the residual-stream
    sequence dim is sharded (Megatron-SP)."""

    mesh: Any
    batch: tuple[str, ...] = ()
    seq: str | None = None

    def resolve(self, logical: str | None) -> tuple[str, ...]:
        return _resolve(logical, self.mesh, tuple(self.batch), self.seq)

    def extent(self, axes: str | Sequence[str] | None) -> int:
        """Product of mesh extents for the given physical axes."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= int(self.mesh.shape[a])
        return n

    def pspec(self, shape: Sequence[int], logical: Sequence[str | None]) -> tuple:
        return _build_spec(shape, logical, self.mesh, tuple(self.batch), self.seq)


_CURRENT: ContextVar[MeshCtx | None] = ContextVar("repro_torch_mesh_ctx", default=None)


def mesh_context() -> MeshCtx | None:
    """The active :class:`MeshCtx`, or None (single-device paths)."""
    return _CURRENT.get()


@contextmanager
def use_mesh(ctx: MeshCtx | None) -> Iterator[MeshCtx | None]:
    """Activate ``ctx`` for the dynamic extent (tracing included): every
    ``shard`` call inside resolves against it."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Redistribute ``x`` by logical axis names; no-op without an active
    mesh or on a plain tensor.  One logical name (or None) per dimension."""
    ctx = mesh_context()
    if ctx is None or not is_dtensor(x):
        return x
    if len(logical) != x.dim():
        raise ValueError(f"shard: {len(logical)} axes for rank-{x.dim()} tensor")
    spec = ctx.pspec(tuple(x.shape), logical)
    if all(e is None for e in spec):
        return x  # a fully replicated constraint would only add traffic
    want = placements(spec, ctx.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# partition-spec factories (the launch layer's contract)
# ---------------------------------------------------------------------------

# Tensor-parallel rules per *leaf name*: logical spec for the core rank.
# Megatron layout: qkv/gate/up column-parallel, o/down row-parallel;
# embeddings vocab-sharded.
_PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    # dense GLU ffn
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    # embeddings / unembedding
    "embed": ("model", None),
    "unembed": (None, "model"),
    # mamba (channel dim d_inner over model)
    "in_proj": (None, "model"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "out_proj": ("model", None),
    "A_log": ("model", None),
    "D": ("model",),
    "dt_bias": ("model",),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    # RG-LRU (width dim over model)
    "w_y": (None, "model"),
    "w_x": (None, "model"),
    "w_r": (None, "model"),
    "w_i": (None, "model"),
    "w_o": ("model", None),
    "lam": ("model",),
    # router stays replicated (tiny, fp32, every shard routes)
    "router": (None, None),
}

# MoE expert weights: [E, d, f] — experts ARE the executor groups, sharded
# over the model axis.
_MOE_RULES: dict[str, tuple[str | None, ...]] = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}


def tree_map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts / lists / tuples; ``path`` holds
    the dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path: tuple) -> str:
    for e in reversed(path):
        if isinstance(e, str):
            return e
    return ""


def _shape_of(leaf: Any) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _fsdp_axis(mesh: Any) -> str | None:
    names = tuple(mesh.axis_names)
    if "data" in names:
        return "data"
    for a in names:
        if a not in _NON_BATCH_AXES:
            return a
    return None


def _param_rule(cfg: Any, name: str, rank: int) -> tuple[str | None, ...]:
    rule = _PARAM_RULES.get(name)
    if getattr(cfg, "n_experts", 0) and name in _MOE_RULES and rank >= 3:
        rule = _MOE_RULES[name]
    if rule is None or rank < len(rule):
        return (None,) * rank
    return (None,) * (rank - len(rule)) + rule


def _apply_fsdp(shape: Sequence[int], spec: tuple, mesh: Any) -> tuple:
    """ZeRO-3: shard the largest still-replicated dim over the data axis."""
    axis = _fsdp_axis(mesh)
    if axis is None:
        return spec
    extent = int(mesh.shape[axis])
    if extent <= 1 or any(axis in _axes_of(e) for e in spec):
        return spec
    best, best_size = -1, 0
    for i, (dim, e) in enumerate(zip(shape, spec)):
        if e is None and dim % extent == 0 and dim > best_size:
            best, best_size = i, dim
    if best < 0:
        return spec
    entries = list(spec)
    entries[best] = axis
    return tuple(entries)


def param_pspecs(cfg: Any, shapes: Any, mesh: Any, *, fsdp: bool = False) -> Any:
    """Spec tree mirroring a params (or train-state) tree.

    Tensor-parallel Megatron rules by leaf name; ``fsdp=True`` additionally
    shards every leaf's largest replicated dim over ``data`` (ZeRO-3).
    Indivisible dims stay replicated — the factories see concrete shapes, so
    aggressive rules are safe.
    """

    def one(path: tuple, leaf: Any) -> tuple:
        shape = _shape_of(leaf)
        name = _leaf_name(path)
        if name == "step":
            return ()
        spec = _build_spec(shape, _param_rule(cfg, name, len(shape)), mesh)
        if fsdp:
            spec = _apply_fsdp(shape, spec, mesh)
        return spec

    return tree_map_with_path(one, shapes)


def state_pspecs(cfg: Any, state_shapes: Any, mesh: Any, *, fsdp: bool = False) -> Any:
    """Specs for the train state ``{"params", "m", "v", "step"}`` — moments
    inherit the parameter rules (fsdp shards them too: that's the ZeRO part),
    ``step`` is replicated."""
    return param_pspecs(cfg, state_shapes, mesh, fsdp=fsdp)


def batch_pspecs(batch_shapes: Any, mesh: Any, global_batch: int) -> Any:
    """Input batches: leading dim over the data axes, rest replicated."""
    bt = batch_axes(mesh, global_batch)

    def one(_path: tuple, leaf: Any) -> tuple:
        shape = _shape_of(leaf)
        rule = ("batch",) + (None,) * max(0, len(shape) - 1)
        return _build_spec(shape, rule[: len(shape)], mesh, bt)

    return tree_map_with_path(one, batch_shapes)


# Cache rules by leaf name (core rank): KV caches are *sequence*-sharded over
# the model axis so MQA archs scale too; recurrent state caches shard their
# channel dim.
_CACHE_RULES: dict[str, tuple[str | None, ...]] = {
    "k": ("batch", "model", None, None),
    "v": ("batch", "model", None, None),
    "pos": (None,),
    # "h" is rank-dispatched in cache_pspecs (mamba rank-3 vs RG-LRU rank-2)
    "conv": ("batch", None, "model"),
    "enc": ("batch", None, None),
}


def cache_pspecs(cfg: Any, cache_shapes: Any, mesh: Any, global_batch: int) -> Any:
    """Specs for a decode/prefill cache tree (``transformer.init_cache``).
    The port's layers are a per-layer list, never a stacked leading dim."""
    bt = batch_axes(mesh, global_batch)

    def one(path: tuple, leaf: Any) -> tuple:
        shape = _shape_of(leaf)
        name = _leaf_name(path)
        if name == "len":
            return ()
        core = len(shape)
        if name == "h":
            # mamba state [B, d_inner, state] vs RG-LRU state [B, width]
            rule = {2: ("batch", "model"), 3: ("batch", "model", None)}.get(core)
        else:
            rule = _CACHE_RULES.get(name)
        if rule is None or core != len(rule):
            return (None,) * len(shape)
        return _build_spec(shape, tuple(rule), mesh, bt)

    return tree_map_with_path(one, cache_shapes)
