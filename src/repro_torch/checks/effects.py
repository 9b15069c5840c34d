"""Per-node buffer effect inference (DESIGN.md §3.3).

Answers, for every node of a captured graph, *which input buffers it reads
and which it writes*.  "Buffer" means a graph **input node** (a param leaf,
a cache pool, a token tensor): inside a graph every op output is a fresh
value, so the only state that can be hazarded across nodes — or across two
graphs sharing tensors, like the paged decode step and a prefill chunk over
one page pool — is the inputs.

Inference walks the fx nodes each captured node carries in its meta
(``_fx_nodes`` / ``_imports`` / ``_exports``, attached by
:mod:`repro_torch.core.capture`), propagating the set of buffer *roots*
every intermediate value is a version of:

* the out-of-place updates (``index_put``, ``index_copy``, ``index_add``,
  ``scatter*``, ``slice_scatter``, ``select_scatter``: the capture's
  ``_SCATTER_UPDATE_ARG`` table) **write** their operand's roots — a
  functional update is a new version of the same logical buffer, and the
  output carries the roots forward;
* an op whose schema marks an argument as mutated (``Tensor(a!)``: the
  in-place aten ops such as ``copy_`` or ``add_``, the ``out=`` forms, and
  any ``repro_torch::*`` custom op registered with ``mutates_args``) writes
  that argument's roots;
* an op whose schema gives its output an alias set of an argument carries
  that argument's roots: every view (``view``, ``reshape``, ``permute``,
  ``transpose``, ``expand``, and the indexing views ``slice``, ``select``,
  ``narrow``, ``split`` / ``unbind``, ``as_strided``) and every in-place
  op's output.  Unlike a JAX value, a torch view shares its input's
  storage: ``pool[i] = x`` traces as ``select`` then ``copy_``, and that
  ``copy_`` writes the pool;
* the copies ``_to_copy``, ``clone`` and ``_unsafe_view`` carry roots too,
  as new versions of the same logical buffer (the JAX package's
  ``convert_element_type`` / ``copy``);
* every other op — ``index_select`` and ``gather`` included — reads its
  operands and produces fresh values.

There are no loop bodies to recurse into: ``make_fx`` unrolls Python loops
and inlines calls, so a scatter inside a loop over layers is one more fx
node of the flat trace, and the JAX package's ``scan`` / ``while`` /
``cond`` walks have no counterpart here.

Hand-built graphs (no fx meta) may annotate nodes explicitly with
``meta={"effects": {"reads": [...], "writes": [...], "carries": [...]}}``;
nodes with neither are treated conservatively as pure readers of everything
their deps carry.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

import torch

from repro_torch.core.capture import _SCATTER_UPDATE_ARG, _op_name
from repro_torch.core.graph import Graph

__all__ = ["NodeEffects", "GraphEffects", "infer_effects", "shared_buffers"]

_EMPTY: frozenset[str] = frozenset()

# copies whose output is a new version of the same logical buffer as
# args[0]; views carry by their schema's alias sets (``_aliased_args``)
_COPY_OPS = {"_to_copy", "clone", "_unsafe_view"}


@dataclass(frozen=True)
class NodeEffects:
    """Buffer footprint of one node.  ``source`` records inference precision:
    ``"fx"`` (traced), ``"annotated"`` (meta), ``"input"`` (buffer root),
    or ``"opaque"`` (no information — conservative reader)."""

    node: str
    reads: frozenset[str]
    writes: frozenset[str]
    source: str = "fx"


@dataclass
class GraphEffects:
    """Effect sets for every node of one graph, at one ``Graph.version``."""

    graph_name: str
    version: int
    buffers: tuple[str, ...]                 # graph input node names
    effects: dict[str, NodeEffects]
    # (node, export slot) -> buffer roots its output carries
    slot_roots: dict[str, tuple[frozenset[str], ...]]

    def writers(self, buf: str) -> list[str]:
        return [n for n, e in self.effects.items() if buf in e.writes]

    def readers(self, buf: str) -> list[str]:
        return [n for n, e in self.effects.items()
                if buf in e.reads and buf not in e.writes]

    def written(self) -> set[str]:
        out: set[str] = set()
        for e in self.effects.values():
            out |= e.writes
        return out

    def read_only(self, bufs: Iterable[str]) -> bool:
        """True when no node writes any of ``bufs`` — the static
        certification behind running this graph concurrently with another
        graph's writes to those buffers."""
        w = self.written()
        return not any(b in w for b in bufs)


def infer_effects(graph: Graph) -> GraphEffects:
    """Infer :class:`NodeEffects` for every node of ``graph``."""
    effects: dict[str, NodeEffects] = {}
    slot_roots: dict[str, tuple[frozenset[str], ...]] = {}
    buffers: list[str] = []

    for name in graph.topo_order():
        node = graph[name]
        if node.fn is None:
            buffers.append(name)
            effects[name] = NodeEffects(name, _EMPTY, _EMPTY, source="input")
            slot_roots[name] = (frozenset({name}),)
            continue
        meta = node.meta or {}

        def dep_roots(dep_idx: int, slot: int, n_slots: int,
                      _node=node) -> frozenset[str]:
            slots = slot_roots.get(_node.deps[dep_idx], ())
            if n_slots <= 1 or len(slots) <= 1:
                return slots[0] if slots else _EMPTY
            return slots[slot] if slot < len(slots) else _EMPTY

        if "_fx_nodes" in meta and "_imports" in meta:
            reads, writes, outs = _fx_effects(meta, dep_roots)
            effects[name] = NodeEffects(name, reads, writes)
            slot_roots[name] = outs
        elif "effects" in meta:
            ann = meta["effects"]
            effects[name] = NodeEffects(
                name,
                reads=frozenset(ann.get("reads", ())),
                writes=frozenset(ann.get("writes", ())),
                source="annotated",
            )
            slot_roots[name] = (frozenset(ann.get("carries", ())),)
        else:
            all_dep = _EMPTY
            for d in node.deps:
                for r in slot_roots.get(d, ()):
                    all_dep |= r
            effects[name] = NodeEffects(name, all_dep, _EMPTY, source="opaque")
            slot_roots[name] = (_EMPTY,)

    return GraphEffects(
        graph_name=graph.name,
        version=graph.version,
        buffers=tuple(buffers),
        effects=effects,
        slot_roots=slot_roots,
    )


# -- fx walk -----------------------------------------------------------------

def _fx_effects(
    meta: Mapping[str, Any],
    dep_roots: Callable[[int, int, int], frozenset[str]],
) -> tuple[frozenset[str], frozenset[str], tuple[frozenset[str], ...]]:
    env: dict[torch.fx.Node, frozenset[str]] = {}
    for src, dep_idx, slot, n_slots in meta["_imports"]:
        env[src] = dep_roots(dep_idx, slot, n_slots)
    reads: set[str] = set()
    writes: set[str] = set()
    for n in meta["_fx_nodes"]:
        env[n] = _walk_node(n, env, reads, writes)
    outs = tuple(env.get(v, _EMPTY) for v in meta["_exports"])
    return frozenset(reads), frozenset(writes), outs


def _aliased_args(node: torch.fx.Node) -> tuple[list[Any], list[Any]]:
    """The arguments ``node``'s op schema gives an alias set: those it marks
    as written (``Tensor(a!)``), and those an output shares storage with
    (``Tensor(a)`` returned as ``Tensor(a)`` or ``Tensor(a)[]``, and the
    written ones returned by an in-place op)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return [], []
    returns_alias = any(r.alias_info is not None for r in schema.returns)
    written, carried = [], []
    for i, arg in enumerate(schema.arguments):
        alias = arg.alias_info
        if alias is None:
            continue
        if i < len(node.args):
            val = node.args[i]
        elif arg.name in node.kwargs:
            val = node.kwargs[arg.name]
        else:
            continue
        if alias.is_write:
            written.append(val)
        if returns_alias:
            carried.append(val)
    return written, carried


def _walk_node(
    n: torch.fx.Node,
    env: Mapping[torch.fx.Node, frozenset[str]],
    reads: set[str],
    writes: set[str],
) -> frozenset[str]:
    """Record one fx node's reads and writes; return the roots its value
    carries."""
    def roots(a: Any) -> frozenset[str]:
        acc = _EMPTY
        for x in _nodes_in(a):
            acc |= env.get(x, _EMPTY)
        return acc

    for a in n.all_input_nodes:
        reads.update(env.get(a, _EMPTY))
    name = _op_name(n)
    first = roots(n.args[0]) if n.args else _EMPTY
    if n.target is operator.getitem:
        return first                      # a part of a tuple-valued op's value
    if name in _SCATTER_UPDATE_ARG:
        writes.update(first)              # functional update of the operand
        return first
    written, carried = _aliased_args(n)
    for a in written:
        writes.update(roots(a))
    if carried:
        out = _EMPTY
        for a in carried:
            out |= roots(a)
        return out
    if name in _COPY_OPS:
        return first
    return _EMPTY


def _nodes_in(a: Any) -> list[torch.fx.Node]:
    found: list[torch.fx.Node] = []
    torch.fx.node.map_arg(a, lambda x: found.append(x) or x)
    return found


# -- cross-graph aliasing ----------------------------------------------------

def shared_buffers(
    bind_a: Mapping[str, Any],
    bind_b: Mapping[str, Any],
) -> list[tuple[str, str]]:
    """Input buffers two graphs share, found by tensor **object identity**
    over their bound name→value input mappings (``CapturedGraph.bind``).

    Two graphs alias state exactly when the caller passes the *same* tensor
    to both — e.g. the serving engine threads one page pool through the
    decode step and every prefill chunk.  Leaf names differ per graph
    (``in.2pages.0k`` vs ``in.1.0k``), so identity, not naming, is the
    ground truth.  Returns ``(name_in_a, name_in_b)`` pairs.
    """
    by_id: dict[int, list[str]] = {}
    for name, val in bind_a.items():
        if val is not None and not isinstance(val, (int, float, bool)):
            by_id.setdefault(id(val), []).append(name)
    pairs: list[tuple[str, str]] = []
    for name_b, val in bind_b.items():
        if val is None or isinstance(val, (int, float, bool)):
            continue
        for name_a in by_id.get(id(val), ()):
            pairs.append((name_a, name_b))
    return pairs
