"""Multi-tensor AdamW on the card: the plan, the leaf table and the wrappers
of the kernels in ``csrc/adamw.cu``.

``optim/adamw.py::adamw_update`` runs its per-leaf loop where
:func:`refusal` names a reason (CPU, meta or fake tensors, a capture in
progress, no leaf), and these kernels on every other tree: plain CUDA
tensors as they are, DTensors as their local shards (:func:`prepare`).  A
tree on the card that the kernels cannot take raises; it never falls back
to the loop.  The loop is the plain version of these kernels: the CPU
tests hold it to the JAX package, the card tests hold the kernels to it,
bit for bit.

* :func:`plan` cuts every leaf into chunks of :data:`CHUNK` elements and the
  leaves into launches of at most :data:`MAX_LEAVES`; it depends on the
  leaves' sizes alone, so :func:`device_plan` keeps it on the device, cached
  by those sizes.
* :func:`leaf_tables` packs a launch's leaves (four pointers, numel, the
  dtype pair, the decay flag) as the kernel's ``Leaf`` array; it is built
  anew each step, since autograd's gradients are new tensors.
* :func:`global_norm_cuda` launches ``adamw_sumsq`` (once a table) and
  ``adamw_finish``: the global norm and the clip scale, on the device (for
  a sharded tree, the partial sums added over the mesh in between).
* :func:`adamw_update_cuda` launches ``adamw_update`` once a table.
"""
from __future__ import annotations

import ctypes
import functools
import sys
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import _build

__all__ = ["CHUNK", "MAX_LEAVES", "Plan", "Prepared", "adamw_update_cuda", "device_plan",
           "global_norm_cuda", "leaf_tables", "local", "plan", "prepare", "refusal"]

CHUNK = 1 << 16          # elements a chunk: csrc/adamw.cu's kChunk
MAX_LEAVES = 640         # leaves a launch's table holds: the kernel's kMaxLeaves
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PLAIN = (torch.Tensor, torch.nn.Parameter)
_count_lock = threading.Lock()


class Plan(NamedTuple):
    """The launches over a tree: ``splits[i] = (lo, hi, first, count)``,
    leaves ``[lo, hi)`` in launch ``i`` and its rows ``[first, first +
    count)`` of ``chunks`` (``[n, 2]`` int32: the leaf's index in its
    launch, the chunk's index in the leaf)."""
    chunks: np.ndarray
    splits: tuple


def plan(numels: Sequence[int]) -> Plan:
    """Every leaf cut into ``CHUNK``-element chunks (a leaf of ``n`` elements
    has ``ceil(n / CHUNK)``: the last ragged, none for an empty leaf), the
    leaves in order, at most ``MAX_LEAVES`` a launch."""
    rows, splits, first = [np.zeros((0, 2), np.int32)], [], 0
    for lo in range(0, len(numels), MAX_LEAVES):
        hi = min(lo + MAX_LEAVES, len(numels))
        count = 0
        for j in range(lo, hi):
            n = -(-int(numels[j]) // CHUNK)
            rows.append(np.stack([np.full(n, j - lo, np.int32), np.arange(n, dtype=np.int32)], 1))
            count += n
        splits.append((lo, hi, first, count))
        first += count
    return Plan(np.concatenate(rows), tuple(splits))


@functools.lru_cache(maxsize=8)
def device_plan(numels: tuple, device: torch.device) -> tuple[torch.Tensor, tuple]:
    """:func:`plan` of these sizes with its chunk list on ``device``, cached
    (the last few trees' plans are kept)."""
    pl = plan(numels)
    return torch.from_numpy(pl.chunks).to(device), pl.splits


def _dtensor_type():
    """``DTensor``, or None where ``torch.distributed.tensor`` was never
    imported (then no leaf is one; its first import takes seconds)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)


def local(t):
    """A DTensor's local shard; any other tensor as it is."""
    dt = _dtensor_type()
    return t.to_local() if dt is not None and isinstance(t, dt) else t


def refusal(p_leaves: Sequence, g_leaves: Sequence, m_leaves: Sequence,
            v_leaves: Sequence) -> str | None:
    """Why the per-leaf loop takes this tree, or None where the kernels do.
    The reasons, the first found in this order: no leaf; a leaf (or a
    DTensor's local shard) that is not a plain tensor (a fake tensor); the
    first leaf not on a CUDA device (the CPU, meta); a capture (``make_fx``,
    FX, ``FakeTensorMode``) in progress.  Every other tree is the kernels'
    (:func:`prepare` raises on what they cannot take)."""
    if not p_leaves:
        return "no leaves"
    for name, leaves in (("parameter", p_leaves), ("gradient", g_leaves),
                         ("first moment", m_leaves), ("second moment", v_leaves)):
        for t in leaves:
            if type(t) not in _PLAIN and type(local(t)) not in _PLAIN:
                return f"a {name} is a {type(local(t)).__name__}"
    dev = p_leaves[0].device
    if dev.type != "cuda":
        return f"the first leaf is on {dev}"
    if trace.capturing():
        return "a capture is in progress"
    return None


class Prepared(NamedTuple):
    """A tree as the kernels take it: the update's tables, chunk list and
    splits over every leaf; ``norm``, the same three over the leaves this
    rank counts in the global norm; ``groups``, the process groups the
    norm's partial sum is added over (none for a plain tree); ``leaves``,
    the p, g, m, v lists the tables point into, held until the kernels have
    been launched (a gradient copied here would otherwise go back to the
    allocator, and the next tensor made on the stream would overwrite it)."""
    tables: list
    chunks: torch.Tensor
    splits: tuple
    norm: tuple
    groups: tuple
    leaves: tuple


def _checked(p_leaves, g_leaves, m_leaves, v_leaves) -> list:
    """The gradients as the kernels read them: a gradient of another float
    dtype than its parameter's or f32 as f32, one not contiguous as a
    contiguous copy (the loop's ``g.float()`` rounds alike).  Raises
    ValueError where a parameter or a moment is not contiguous, a
    parameter is not bf16, fp16 or f32, a moment not f32, shapes differ or
    a leaf is not on the first leaf's device: the loop would take such a
    tree only at its own speed, unnoticed."""
    dev = p_leaves[0].device
    gs = list(g_leaves)
    for i, (p, g, m, v) in enumerate(zip(p_leaves, g_leaves, m_leaves, v_leaves)):
        if p.dtype not in _CODES or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"adamw kernels: leaf {i} has dtypes {p.dtype} / {m.dtype} / "
                             f"{v.dtype} (parameter bf16, fp16 or f32; moments f32)")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"adamw kernels: leaf {i}'s parameter or moments are not "
                             f"contiguous")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adamw kernels: leaf {i} has shapes " + " / ".join(
                str(tuple(t.shape)) for t in (p, g, m, v)))
        if not p.device == g.device == m.device == v.device == dev:
            raise ValueError(f"adamw kernels: leaf {i} is not all on {dev}")
        if g.dtype != p.dtype and g.dtype != torch.float32:
            g = g.float()
        if not g.is_contiguous():
            g = g.contiguous()
        gs[i] = g
    return gs


def _shards(p_leaves, g_leaves, m_leaves, v_leaves, dt) -> tuple:
    """The local shards of a tree of DTensors, which leaves this rank counts
    in the global norm, and the mesh's process groups.  Each gradient is
    first redistributed to its parameter's placements (a Partial one
    summed, as the loop's ops would); a leaf replicated over a mesh
    dimension counts on the ranks at coordinate 0 of that dimension, so the
    sum over the whole mesh counts it once."""
    mesh = p_leaves[0].device_mesh
    coord = mesh.get_coordinate()
    out = ([], [], [], [])
    counted = []
    for i, (p, g, m, v) in enumerate(zip(p_leaves, g_leaves, m_leaves, v_leaves)):
        if not all(isinstance(t, dt) and t.device_mesh == mesh for t in (p, g, m, v)):
            raise ValueError(f"adamw kernels: leaf {i} mixes DTensors of another mesh or "
                             f"plain tensors into a tree of DTensors")
        pl = tuple(p.placements)
        if any(x.is_partial() for x in pl) or tuple(m.placements) != pl \
                or tuple(v.placements) != pl:
            raise ValueError(f"adamw kernels: leaf {i}: parameter placed {pl}, moments "
                             f"{tuple(m.placements)} / {tuple(v.placements)}")
        if tuple(g.placements) != pl:
            g = g.redistribute(mesh, pl)
        counted.append(all(c == 0 for c, x in zip(coord, pl) if x.is_replicate()))
        for dst, t in zip(out, (p, g, m, v)):
            dst.append(t.to_local())
    groups = tuple(mesh.get_group(d) for d in range(mesh.ndim) if mesh.size(d) > 1)
    return out, counted, groups


def prepare(p_leaves: Sequence, g_leaves: Sequence, m_leaves: Sequence, v_leaves: Sequence,
            decay: Sequence[bool]) -> Prepared:
    """The kernels' inputs for a tree :func:`refusal` passed: plain CUDA
    tensors, or DTensors on one mesh (their local shards).  Raises
    ValueError on a tree the kernels cannot take (``_checked``)."""
    dt = _dtensor_type()
    counted, groups = None, ()
    if dt is not None and isinstance(p_leaves[0], dt):
        (p_leaves, g_leaves, m_leaves, v_leaves), counted, groups = _shards(
            p_leaves, g_leaves, m_leaves, v_leaves, dt)
    elif dt is not None and any(isinstance(t, dt) for t in g_leaves):
        raise ValueError("adamw kernels: DTensor gradients of plain parameters")
    g_leaves = _checked(p_leaves, g_leaves, m_leaves, v_leaves)
    dev = p_leaves[0].device
    chunks, splits = device_plan(tuple(p.numel() for p in p_leaves), dev)
    tables = leaf_tables(p_leaves, g_leaves, m_leaves, v_leaves, decay, splits)
    norm = (tables, chunks, splits)
    if counted is not None and not all(counted):
        gs = [g for g, c in zip(g_leaves, counted) if c]
        n_chunks, n_splits = device_plan(tuple(g.numel() for g in gs), dev)
        norm = (leaf_tables(gs, gs, gs, gs, [False] * len(gs), n_splits), n_chunks, n_splits)
    return Prepared(tables, chunks, splits, norm, groups,
                    (p_leaves, g_leaves, m_leaves, v_leaves))


def leaf_tables(p_leaves: Sequence, g_leaves: Sequence, m_leaves: Sequence, v_leaves: Sequence,
                decay: Sequence[bool], splits: tuple) -> list[np.ndarray]:
    """Each launch's table, the kernel's ``Leaf`` array as ``[n, 6]`` int64:
    the pointers of p, g, m and v, numel, and ``kind + (decay << 32)``
    (``kind`` = p's dtype code times 3 plus g's)."""
    rows = [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
             _CODES[p.dtype] * 3 + _CODES[g.dtype] + (int(bool(d)) << 32))
            for p, g, m, v, d in zip(p_leaves, g_leaves, m_leaves, v_leaves, decay)]
    return [np.array(rows[lo:hi], dtype=np.int64).reshape(-1, 6) for lo, hi, _, _ in splits]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = _build.load("adamw")
    lib.adamw_max_leaves.restype = ctypes.c_int
    lib.adamw_chunk.restype = ctypes.c_int
    if lib.adamw_max_leaves() != MAX_LEAVES or lib.adamw_chunk() != CHUNK:
        raise RuntimeError(f"adamw kernel: {lib.adamw_max_leaves()} leaves a launch and chunks "
                           f"of {lib.adamw_chunk()}, ops.py plans {MAX_LEAVES} and {CHUNK}")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.adamw_sumsq.argtypes = [vp, i, vp, i, vp, vp]
    lib.adamw_finish.argtypes = [vp, i, ctypes.c_float, vp, vp]
    lib.adamw_update.argtypes = [vp, i, vp, i] + [vp] * 4 + [ctypes.c_float] * 6 + [vp]
    for fn in (lib.adamw_sumsq, lib.adamw_finish, lib.adamw_update):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adamw {what} kernel launch failed: CUDA error {err}")


def global_norm_cuda(tables: list[np.ndarray], chunks: torch.Tensor, splits: tuple,
                     clip_norm: float, groups: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gnorm, scale)``, 0-dim f32 on the device: the global norm of the
    gradients (squares in f32, summed in a fixed order) and ``min(clip_norm /
    max(gnorm, 1e-12), 1)``.  ``tables``, ``chunks``, ``splits``: from
    :func:`leaf_tables` and :func:`device_plan` (only the gradients' pointers
    are read).  ``groups``: process groups over which the partial sums'
    total is added before the root is taken (a sharded tree's, from
    :func:`prepare`).  Counts each launch in ``global_norm_cuda.launches``."""
    dev = chunks.device
    n_chunks = int(chunks.shape[0])
    partials = torch.empty(n_chunks, dtype=torch.float64, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    for table, (lo, hi, first, count) in zip(tables, splits):
        _check(lib.adamw_sumsq(table.ctypes.data, hi - lo, chunks[first:].data_ptr(), count,
                               partials[first:].data_ptr(), stream), "sumsq")
    if groups:
        import torch.distributed as dist

        partials = partials.sum(0, keepdim=True)
        for group in groups:
            dist.all_reduce(partials, group=group)
    _check(lib.adamw_finish(partials.data_ptr(), partials.numel(), clip_norm, out.data_ptr(),
                            stream), "finish")
    with _count_lock:
        global_norm_cuda.launches += len(splits) + 1
    return out[0], out[1]


global_norm_cuda.launches = 0


def adamw_update_cuda(tables: list[np.ndarray], chunks: torch.Tensor, splits: tuple,
                      scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                      b2c: torch.Tensor, *, b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """The update of every leaf in ``tables``, in place, on the current
    stream.  ``scale``, ``lr``, ``b1c``, ``b2c``: 0-dim f32 on the device;
    ``b1`` ... ``weight_decay`` as the config holds them (``1 - b1`` and ``1 -
    b2`` taken in Python's float, then rounded to f32, as the loop's scalars
    are).  Counts each launch in ``adamw_update_cuda.launches``."""
    for t in (scale, lr, b1c, b2c):
        if t.dtype != torch.float32 or t.numel() != 1 or not t.is_cuda:
            raise ValueError(f"adamw_update_cuda: scalars must be one f32 on the card, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    stream = torch.cuda.current_stream(scale.device).cuda_stream
    lib = _lib()
    for table, (lo, hi, first, count) in zip(tables, splits):
        _check(lib.adamw_update(table.ctypes.data, hi - lo, chunks[first:].data_ptr(), count,
                                scale.data_ptr(), lr.data_ptr(), b1c.data_ptr(), b2c.data_ptr(),
                                b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, stream),
               "update")
    with _count_lock:
        adamw_update_cuda.launches += len(splits)


adamw_update_cuda.launches = 0
