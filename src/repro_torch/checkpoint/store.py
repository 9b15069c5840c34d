"""Atomic, keep-N checkpoints of the port's training state, in the JAX
package's on-disk layout.

Layout: ``<dir>/step_<k>/state.npz`` (flattened state, '/'-joined keys)
plus ``meta.json``; a checkpoint directory is **atomically** published via
``os.rename`` of a ``.tmp`` staging dir — a crash mid-save never corrupts
the latest restorable step.

The layout is the JAX package's ``checkpoint/store.py``, key for key, so
checkpoints cross between the two packages both ways (the port's state
keeps a per-layer list, ``params/layers/<i>/...``: the JAX package's layout
for a config with ``scan_layers=False``).  numpy has no bfloat16, and the
card's host has no ``ml_dtypes``: extension dtypes (bf16, fp8) are stored
as uint8 with a trailing itemsize axis and their dtype's name under
``ext_dtypes`` in meta.json, and this package encodes and decodes them by
viewing those bytes as the torch dtype.  Loaded leaves are CPU tensors;
``restore_state`` moves each onto its template leaf's device and dtype.

Sharded states (DTensor leaves, ``repro_torch.dist``) are saved as full
tensors, gathered on every rank and written by rank 0 alone, so a
checkpoint does not depend on the mesh it came from; ``restore_state``
places each leaf onto whatever mesh the template (or ``placements=``) names
(the elastic re-mesh: a checkpoint from one rank restores onto ``2x2``).

``CheckpointManager`` adds async save (background thread; ``wait()`` joins)
and keep-N pruning.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "list_steps",
    "prune",
    "restore_state",
    "CheckpointManager",
]

_SEP = "/"
# extension dtypes: their names in meta.json (numpy's / ml_dtypes' names)
_EXT = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}
_EXT_NAME = {dt: name for name, dt in _EXT.items()}


def _path_str(entry) -> str:
    if isinstance(entry, pytree.MappingKey):
        return str(entry.key)
    if isinstance(entry, pytree.SequenceKey):
        return str(entry.idx)
    if isinstance(entry, pytree.GetAttrKey):
        return str(entry.name)
    return str(entry)


def _key(path) -> str:
    return _SEP.join(_path_str(p) for p in path)


def _is_dtensor(x: Any) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _host(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's snapshot in host memory (a DTensor's full tensor: every
    rank gathers it)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    return leaf.detach().to("cpu", copy=True)


def _encode(leaf: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """(array for the npz, extension dtype name or None)."""
    t = leaf.detach().cpu().contiguous()
    name = _EXT_NAME.get(t.dtype)
    if name is None:
        return t.numpy(), None
    raw = t.reshape(-1).view(torch.uint8).reshape(tuple(t.shape) + (t.element_size(),))
    return raw.numpy(), name


def _flatten(state: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Returns (arrays, extended-dtype map)."""
    flat, exts = {}, {}
    for path, leaf in pytree.tree_flatten_with_path(state)[0]:
        key = _key(path)
        flat[key], name = _encode(leaf)
        if name is not None:
            exts[key] = name
    return flat, exts


def save_checkpoint(directory: str, step: int, state: Any, *, keep: int | None = None) -> str:
    """Write ``state`` (a pytree of tensors) for ``step``; returns the
    published path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, exts = _flatten(state)
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(flat), "ext_dtypes": exts}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    if keep is not None:
        prune(directory, keep)
    return final


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "meta.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def prune(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    """uint8 [..., itemsize] bytes as a tensor of the extension dtype."""
    if name not in _EXT:
        raise ValueError(f"checkpoint: extension dtype {name!r} has no torch counterpart")
    shape = arr.shape[:-1]
    raw = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1)
    return raw.view(_EXT[name]).reshape(shape)


def load_checkpoint(directory: str,
                    step: int | None = None) -> tuple[int, dict[str, torch.Tensor]]:
    """Load the flat dict of CPU tensors for ``step`` (default: latest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    exts = meta.get("ext_dtypes", {})
    flat: dict[str, torch.Tensor] = {}
    with np.load(os.path.join(base, "state.npz")) as z:
        for k in z.files:
            flat[k] = _decode(z[k], exts[k]) if k in exts else torch.from_numpy(z[k])
    return step, flat


def _is_placements(x: Any) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, (tuple, list)) and all(isinstance(p, Placement) for p in x)


def restore_state(template: Any, flat: dict[str, torch.Tensor], *,
                  placements: Any = None, device_mesh: Any = None) -> Any:
    """Rebuild the structure of ``template`` (a pytree of tensors) from a
    flat dict, each leaf in its template leaf's dtype: on the template
    leaf's device, or, for a DTensor template leaf, distributed onto its
    mesh with its placements.  ``placements`` (a tree matching
    ``template`` whose leaves are DTensor placement tuples) with
    ``device_mesh`` puts every leaf onto that mesh instead: the elastic
    re-mesh, full tensors onto whatever mesh is current.  Each rank keeps
    its own shard of the full tensor it loaded (no communication)."""
    paths, treedef = pytree.tree_flatten_with_path(template)
    keys = [_key(path) for path, _ in paths]
    missing = [k for k in keys if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} leaves, e.g. {missing[:3]}")
    pls = [None] * len(paths)
    if placements is not None:
        if device_mesh is None:
            raise ValueError("restore_state: placements= needs device_mesh=")
        pls = pytree.tree_leaves(placements, is_leaf=_is_placements)
        if len(pls) != len(paths):
            raise ValueError(f"restore_state: {len(pls)} placements for {len(paths)} leaves")

    def one(k: str, t: torch.Tensor, pl) -> torch.Tensor:
        from_disk = flat[k].to(dtype=t.dtype)
        mesh = device_mesh
        if pl is None and _is_dtensor(t):
            mesh, pl = t.device_mesh, tuple(t.placements)
        if pl is None:
            return from_disk.to(device=t.device)
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(from_disk.to(mesh.device_type), mesh, pl, src_data_rank=None)

    leaves = [one(k, t, pl) for k, (_, t), pl in zip(keys, paths, pls)]
    return pytree.tree_unflatten(leaves, treedef)


class CheckpointManager:
    """keep-N manager with optional async (background-thread) saves."""

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def save(self, step: int, state: Any) -> None:
        # snapshot to host memory *before* handing to the thread so ongoing
        # in-place updates (the optimizer's) can't mutate what we write
        host_state = pytree.tree_map(_host, state)
        self.wait()
        if not _writer():
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=save_checkpoint,
                args=(self.directory, step, host_state),
                kwargs={"keep": self.keep},
                daemon=True,
            )
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host_state, keep=self.keep)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, template: Any, *, step: int | None = None) -> tuple[int, Any]:
        step, flat = load_checkpoint(self.directory, step)
        return step, restore_state(template, flat)
