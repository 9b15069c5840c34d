"""PyTorch function → :class:`Graph` capture (the front half of ``compile``).

``capture(fn, *specs)`` is the counterpart of the JAX package's
``jax.make_jaxpr`` capture.  It traces ``fn`` with
``make_fx(tracing_mode="fake")`` (shapes and dtypes only: no device work),
fuses data-movement and elementwise chains into their single consumer, and
emits one :class:`OpNode` per surviving group of aten ops.  Every node
carries

* roofline statistics (``flops`` / ``bytes_in`` / ``bytes_out``) with the
  JAX package's conventions (DESIGN.md §3): a matrix product costs
  2·|out|·K, elementwise ops |out|, reductions |in|, data movement 0, a
  scatter (``index_put``) its update size rather than the buffer it passes
  through, the paged-attention custom op the pages its table can reach,
  the fused LSTM cell 8 per gate element (one node per cell, never
  fused, exporting ``(h, c')``), the grouped expert matmul of a MoE
  FFN ``2·E·C·D·F`` (a ``gemm`` node of C rows), and the two recurrent
  scans (Mamba's selective scan, RG-LRU's recurrence: one node each of
  their own kind, never fused into a consumer, exporting ``(y, h_last)``)
  by their bytes — their inputs read and outputs written once, against a
  few flops per element; MoE routing's slot assignment likewise (one node
  of kind ``moe_route_slots``: its expert ids read and its four tables
  written, one rank a claim);
* a runnable ``fn`` that replays the group's aten ops, so the sequential
  oracle ``Graph.execute`` and the host runtimes reproduce the eager call
  bit-exactly.

Argument pytrees (``params`` / ``cache`` dicts of lists) are flattened with
``torch.utils._pytree`` so they stay Python containers during the trace.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode
from torch.fx.node import map_arg
from torch.utils import _pytree as pytree

from .graph import Graph

__all__ = ["CapturedGraph", "capture"]


# -- aten op classification --------------------------------------------------

# moe_gmm: the grouped per-expert matmul (kernel B5), [E,C,D] x [E,D,F];
# moe_gmm_bwd: its gradient's two products (dX and dW) in one node
_GEMM_OPS = {"mm", "bmm", "addmm", "baddbmm", "moe_gmm", "moe_gmm_bwd"}
# pure data movement / layout / index construction: zero flops, fused into
# consumers when possible
_MOVEMENT_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "select", "slice", "index", "index_select",
    "gather", "where", "_to_copy", "cat", "stack", "clone", "alias", "detach",
    "arange", "full", "zeros", "ones", "empty", "scalar_tensor",
    "lift_fresh_copy", "repeat_interleave", "nonzero", "getitem", "copy",
    "split", "split_with_sizes", "unbind", "expand_as", "as_strided",
    "new_zeros", "new_empty", "repeat", "flatten", "_reshape_alias",
    "view_as", "contiguous",
}
# scatters pass their buffer through and touch only the update (arg index)
_SCATTER_UPDATE_ARG = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                       "index_copy": 3, "index_add": 3, "scatter": 3,
                       "scatter_add": 3, "slice_scatter": 1, "select_scatter": 1}
_REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "_softmax", "softmax", "_log_softmax", "log_softmax", "cumsum", "prod",
    "var", "std", "logsumexp", "all", "any", "sort", "topk", "norm",
}
# custom ops of this package that are attention over a paged KV pool
_PAGED_ATTENTION_OPS = {"paged_decode_attention"}
# and every attention custom op (one graph node each, kernel B1 / B2 / B3;
# B3's training forward and its backward, in a captured gradient)
_FLASH_TRAIN_OPS = {"flash_attention_train", "flash_attention_bwd"}
_ATTENTION_OPS = (_PAGED_ATTENTION_OPS | {"decode_attention", "flash_attention"}
                  | _FLASH_TRAIN_OPS)
# the fused LSTM cell (kernel B4) and its backward: their own kind, never
# fused into a neighbour, so the runtime graph keeps the paper's one node
# per cell
_LSTM_CELL_OPS = {"lstm_cell", "lstm_cell_bwd"}
# the recurrent scans (kernels B6 / B7) and their backwards: their own
# kinds, never fused into a neighbour, like the LSTM cell
_SCAN_OPS = {"ssm_scan", "ssm_scan_train", "rglru_scan", "ssm_scan_bwd", "rglru_scan_bwd"}
# MoE routing's slot assignment: its own kind, never fused into a
# neighbour; its bytes are the expert ids read and the tables written
_ROUTE_OPS = {"moe_route_slots"}
# ops whose value is a tuple: the getitems that unpack one join its node
# (the LSTM cell's (h, c'), a scan's (y, h_last), top-k's (values,
# indices) in MoE routing, the grouped matmul's (dx, dw), the slot
# assignment's (positions, keep, slot_tok, counts))
_TUPLE_OPS = (_LSTM_CELL_OPS | _SCAN_OPS | _FLASH_TRAIN_OPS | _ROUTE_OPS
              | {"topk", "moe_gmm_bwd"})

_FUSABLE_KINDS = ("movement", "elementwise")


def _op_name(node: torch.fx.Node) -> str:
    target = node.target
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _kind_of(node: torch.fx.Node) -> str:
    name = _op_name(node)
    if name in _ATTENTION_OPS:
        return "attention"
    if name in _LSTM_CELL_OPS:
        return "lstm_cell"
    if name in _SCAN_OPS or name in _ROUTE_OPS:
        return name
    if name in _GEMM_OPS:
        return "gemm"
    if name in _MOVEMENT_OPS:
        return "movement"
    if name in _REDUCE_OPS:
        return "reduce"
    return "elementwise"


# -- value helpers -----------------------------------------------------------

def _dim(d: Any) -> int:
    """A size as an int; a data-dependent size (``nonzero``) counts at the
    upper bound the tracer proved for it."""
    try:
        return int(d)
    except GuardOnDataDependentSymNode:
        upper = d.node.shape_env.bound_sympy(d.node.expr).upper
        return int(upper) if upper.is_finite else 1


def _numel(val: Any) -> float:
    if isinstance(val, torch.Tensor):
        n = 1
        for d in val.shape:
            n *= _dim(d)
        return float(n)
    if isinstance(val, (tuple, list)):
        return sum(_numel(v) for v in val)
    return 0.0


def _nbytes(val: Any) -> float:
    if isinstance(val, torch.Tensor):
        return _numel(val) * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(_nbytes(v) for v in val)
    return 0.0


def _val(x: Any) -> Any:
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else x


def _tensor_args(node: torch.fx.Node) -> list[Any]:
    return [_val(a) for a in node.args if isinstance(a, torch.fx.Node)]


def _paged_reach(node: torch.fx.Node) -> tuple[float, float]:
    """(flops, bytes of K/V) a paged-attention call can touch: every row
    reads the pages its table maps, ``n_pt * ps`` entries of ``Hkv`` heads,
    never more than the pools hold."""
    q, kp, _vp, table = (_val(a) for a in node.args[:4])
    B, Hq, hd = (_dim(d) for d in q.shape)
    P, ps, Hkv, _ = (_dim(d) for d in kp.shape)
    n_pt = _dim(table.shape[1])
    entries = B * n_pt * ps
    flops = 4.0 * entries * Hq * hd
    kv_bytes = 2.0 * min(entries, P * ps) * Hkv * hd * kp.element_size()
    return flops, kv_bytes


def _node_flops(node: torch.fx.Node) -> float:
    name = _op_name(node)
    out = _val(node)
    if name in _PAGED_ATTENTION_OPS:
        return _paged_reach(node)[0]
    if name == "decode_attention":       # q [B, Hq, hd] against every cache entry
        q, kc = _val(node.args[0]), _val(node.args[1])
        return 4.0 * _numel(q) * _dim(kc.shape[1])
    if name in ("flash_attention", "flash_attention_train"):
        # q [B, Sq, Hq, hd] against k [B, Skv, ...]: two products
        q, k = _val(node.args[0]), _val(node.args[1])
        half = 0.5 if node.args[3] else 1.0   # causal: half the pairs are kept
        return 4.0 * half * _numel(q) * _dim(k.shape[1])
    if name == "flash_attention_bwd":    # (dout, q, k, ...): five products
        q, k = _val(node.args[1]), _val(node.args[2])
        half = 0.5 if node.args[6] else 1.0
        return 10.0 * half * _numel(q) * _dim(k.shape[1])
    if name in _LSTM_CELL_OPS:           # ~8 ops per element of gx [N, 4H]
        return 8.0 * _numel(_val(node.args[0]))
    if name in ("ssm_scan", "ssm_scan_train"):   # a [B,S,D,St]: h = a·h + b, y += h·c
        return 4.0 * _numel(_val(node.args[0]))
    if name == "rglru_scan":             # a [B,S,R]: h = a·h + b
        return 2.0 * _numel(_val(node.args[0]))
    if name == "ssm_scan_bwd":           # the chain re-run, then g, da, dc's term
        return 8.0 * _numel(_val(node.args[0]))
    if name == "rglru_scan_bwd":         # g = dhs + g, da = g·h, g = g·a
        return 3.0 * _numel(_val(node.args[0]))
    if name in _ROUTE_OPS:               # one rank a claim of expert_idx [G, Tg, k]
        return _numel(_val(node.args[0]))
    if name == "moe_gmm_bwd":            # (x, w, dy): dX and dW, 2·E·C·D·F each
        x, w = _val(node.args[0]), _val(node.args[1])
        return 4.0 * _numel(x) * _dim(w.shape[-1])
    if name in ("mm", "bmm", "moe_gmm"):     # moe_gmm: 2·E·C·D·F
        return 2.0 * _numel(out) * _dim(_val(node.args[0]).shape[-1])
    if name in ("addmm", "baddbmm"):
        return 2.0 * _numel(out) * _dim(_val(node.args[1]).shape[-1])
    if name in _SCATTER_UPDATE_ARG:
        # a paged-KV decode writes one token row into a pool thousands of
        # times larger than the work done: price the update, not the buffer
        i = _SCATTER_UPDATE_ARG[name]
        upd = node.args[i] if len(node.args) > i else node
        return _numel(_val(upd))
    kind = _kind_of(node)
    if kind == "movement":
        return 0.0
    if kind == "reduce":
        args = _tensor_args(node)
        return _numel(args[0]) if args else 0.0
    return _numel(out)


def _gemm_rows(node: torch.fx.Node) -> int | None:
    """M (the paper's MKL panel dimension) of a matrix product, for the
    cost model's tall-skinny scaling cap."""
    name = _op_name(node)
    if name in ("mm", "bmm", "moe_gmm", "moe_gmm_bwd"):     # moe_gmm: C slots per expert
        return _dim(_val(node.args[0]).shape[-2])
    if name in ("addmm", "baddbmm"):
        return _dim(_val(node.args[1]).shape[-2])
    return None


# -- captured graph ----------------------------------------------------------

@dataclass
class CapturedGraph:
    """A :class:`Graph` plus the pytree plumbing to call it like ``fn``.

    ``bind(args)`` maps a concrete argument tuple onto the graph's input
    nodes; ``unflatten(results)`` reassembles ``fn``'s output pytree from a
    per-node result mapping (as produced by ``Graph.execute`` or
    ``HostScheduler.run``); ``run(*args)`` is the sequential oracle.
    """

    graph: Graph
    name: str
    in_tree: Any
    n_in_leaves: int
    input_names: dict[int, str]          # used leaf index -> input node name
    out_tree: Any
    out_spec: list[tuple] = field(repr=False, default_factory=list)
    n_ops: int = 0                       # traced aten op count, pre-fusion
    gm: torch.fx.GraphModule | None = field(repr=False, default=None)

    def bind(self, args: Sequence[Any]) -> dict[str, Any]:
        leaves, in_tree = pytree.tree_flatten(tuple(args))
        if in_tree != self.in_tree or len(leaves) != self.n_in_leaves:
            raise TypeError(
                f"{self.name}: argument structure {in_tree} does not match "
                f"the captured structure {self.in_tree}"
            )
        return {self.input_names[i]: leaves[i] for i in self.input_names}

    def unflatten(self, results: Mapping[str, Any]) -> Any:
        leaves = []
        for spec in self.out_spec:
            if spec[0] == "node":
                _, node, slot, n_slots = spec
                val = results[node]
                leaves.append(val if n_slots == 1 else val[slot])
            elif spec[0] == "input":
                leaves.append(results[self.input_names[spec[1]]])
            else:  # const
                leaves.append(spec[1])
        return pytree.tree_unflatten(leaves, self.out_tree)

    def run(self, *args: Any) -> Any:
        """Execute via the sequential interpreter (the correctness oracle)."""
        return self.unflatten(self.graph.execute(self.bind(args)))


# -- node fn builder ---------------------------------------------------------

def _make_node_fn(members, imports, const_bindings, exports):
    """Build a node ``fn(*dep_vals) -> value | tuple`` replaying member ops.

    ``imports``: per imported fx node ``(node, dep_index, slot, n_slots)``.
    """

    def run(*dep_vals: Any) -> Any:
        env: dict[Any, Any] = dict(const_bindings)
        for n, dep_idx, slot, n_slots in imports:
            val = dep_vals[dep_idx]
            env[n] = val if n_slots == 1 else val[slot]
        for m in members:
            args = map_arg(m.args, env.__getitem__)
            kwargs = map_arg(m.kwargs, env.__getitem__)
            env[m] = m.target(*args, **kwargs)
        vals = tuple(env[v] for v in exports)
        return vals[0] if len(vals) == 1 else vals

    return run


# -- main entry --------------------------------------------------------------

def _leaf_name(i: int, path: Any) -> str:
    raw = pytree.keystr(path)
    keep = "".join(c for c in raw if c.isalnum() or c in "._")
    keep = keep.strip("._")  # noqa: B005 — char-set strip is the intent
    return f"in.{keep[-48:]}" if keep else f"in.{i}"


def capture(fn, *specs: Any, name: str | None = None, fuse: bool = True) -> CapturedGraph:
    """Trace ``fn(*specs)`` and build the schedulable computation graph.

    ``specs`` are example arguments: pytrees whose tensor leaves give the
    shapes, dtypes and devices (only those are read — the trace runs on
    fake tensors).  Non-tensor leaves are baked in as constants.
    ``fuse=False`` keeps one node per aten op (debugging aid).  ``fn`` must
    be traceable: no ``.item()`` and no Python branch on tensor values.
    """
    gname = name or getattr(fn, "__name__", None) or "captured"
    in_leaves_p, in_tree = pytree.tree_flatten_with_path(tuple(specs))
    leaves = [leaf for _, leaf in in_leaves_p]
    tensor_idx = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]
    box: dict[str, Any] = {}

    def flat_fn(*tensors: torch.Tensor) -> list:
        full = list(leaves)
        for i, t in zip(tensor_idx, tensors):
            full[i] = t
        out = fn(*pytree.tree_unflatten(full, in_tree))
        out_leaves, box["out_tree"] = pytree.tree_flatten(out)
        box["consts"] = {j: v for j, v in enumerate(out_leaves)
                         if not isinstance(v, torch.Tensor)}
        return [v for v in out_leaves if isinstance(v, torch.Tensor)]

    gm = make_fx(flat_fn, tracing_mode="fake")(*[leaves[i] for i in tensor_idx])
    fx_graph = gm.graph
    fx_graph.eliminate_dead_code()

    placeholder_leaf: dict[torch.fx.Node, int] = {}
    ops: list[torch.fx.Node] = []
    consts: dict[torch.fx.Node, Any] = {}
    out_nodes: list[Any] = []
    ph = iter(tensor_idx)
    for n in fx_graph.nodes:
        if n.op == "placeholder":
            placeholder_leaf[n] = next(ph)
        elif n.op == "get_attr":
            consts[n] = getattr(gm, n.target)
        elif n.op == "call_function":
            ops.append(n)
        elif n.op == "output":
            out_nodes = list(pytree.tree_leaves(n.args[0]))
    op_index = {n: i for i, n in enumerate(ops)}

    # consumers of each op by op index (graph outputs tracked separately)
    consumers: dict[torch.fx.Node, list[int]] = {}
    for i, n in enumerate(ops):
        for a in n.all_input_nodes:
            if a in op_index:
                consumers.setdefault(a, []).append(i)
    graph_out = {n for n in out_nodes if isinstance(n, torch.fx.Node)}

    # fusion: walking consumers-first, a movement/elementwise op whose
    # output feeds exactly one surviving group folds into it.  Producers
    # precede consumers in an fx graph, so every group's anchor is its
    # max-index op and cross-group edges start only at anchors — no cycle.
    # The one exception: the ``getitem``s that unpack a tuple-valued op (an
    # LSTM cell, a top-k) join their producer's group, so that node exports
    # the tuple's parts itself (one node, not three); they only read the
    # anchor, and their consumers come after them, so no cycle either.
    group = list(range(len(ops)))

    def find(i: int) -> int:
        while group[i] != i:
            group[i] = group[group[i]]
            i = group[i]
        return i

    if fuse:
        for i in range(len(ops) - 1, -1, -1):
            src = ops[i].args[0] if ops[i].args else None
            if (_op_name(ops[i]) == "getitem" and src in op_index
                    and _op_name(src) in _TUPLE_OPS):
                group[i] = op_index[src]
                continue
            if _kind_of(ops[i]) not in _FUSABLE_KINDS or ops[i] in graph_out:
                continue
            targets = {find(c) for c in consumers.get(ops[i], [])}
            if len(targets) == 1:
                group[i] = targets.pop()

    members: dict[int, list[int]] = {}
    for i in range(len(ops)):
        members.setdefault(find(i), []).append(i)

    g = Graph(gname)

    # input source nodes (used leaves only)
    used = [p for p in placeholder_leaf if p.users or p in graph_out]
    input_names: dict[int, str] = {}
    taken: set[str] = set()
    for p in sorted(used, key=placeholder_leaf.__getitem__):
        i = placeholder_leaf[p]
        nm = _leaf_name(i, in_leaves_p[i][0])
        if nm in taken:
            nm = f"{nm}.{i}"
        taken.add(nm)
        input_names[i] = nm
        g.add_op(nm, kind="input", bytes_out=_nbytes(_val(p)))

    # where does a value live? -> (node name, slot, n_slots)
    home: dict[torch.fx.Node, tuple[str, int, int]] = {}
    for p in used:
        home[p] = (input_names[placeholder_leaf[p]], 0, 1)

    op_counts: dict[str, int] = {}
    for anchor in sorted(members):
        grp = [ops[i] for i in members[anchor]]
        own = set(grp)

        exports: list[torch.fx.Node] = []
        for n in grp:
            external = any(find(c) != anchor for c in consumers.get(n, []))
            if (external or n in graph_out) and n not in exports:
                exports.append(n)
        if not exports:                   # dead group head: export the anchor
            exports = [ops[anchor]]

        imports: list[torch.fx.Node] = []
        const_bindings: dict[torch.fx.Node, Any] = {}
        for n in grp:
            for a in n.all_input_nodes:
                if a in own:
                    continue
                if a in consts:
                    const_bindings[a] = consts[a]
                elif a not in imports:
                    imports.append(a)

        dep_names: list[str] = []
        import_spec: list[tuple] = []
        for a in imports:
            h = home.get(a)
            if h is None:
                raise ValueError(f"capture({gname}): unplaced value {a.name} in group "
                                 f"{_op_name(ops[anchor])}")
            nm, slot, n_slots = h
            if nm not in dep_names:
                dep_names.append(nm)
            import_spec.append((a, dep_names.index(nm), slot, n_slots))

        anchor_op = ops[anchor]
        op = _op_name(anchor_op)
        ordinal = op_counts.get(op, 0)
        op_counts[op] = ordinal + 1
        node_name = f"{op}.{ordinal}"

        flops = sum(_node_flops(n) for n in grp)
        # a pool that only feeds paged attention is read as far as the
        # tables reach, not whole
        pool_reach: dict[torch.fx.Node, float] = {}
        for n in grp:
            if _op_name(n) in _PAGED_ATTENTION_OPS:
                half = _paged_reach(n)[1] / 2.0
                for a in n.args[1:3]:
                    pool_reach[a] = pool_reach.get(a, 0.0) + half
        bytes_in = 0.0
        for a in imports:
            full = _nbytes(_val(a))
            only_pool = a in pool_reach and all(
                u not in own or _op_name(u) in _PAGED_ATTENTION_OPS for u in a.users)
            bytes_in += min(full, pool_reach[a]) if only_pool else full
        bytes_in += sum(float(c.nbytes) for c in const_bindings.values()
                        if isinstance(c, torch.Tensor))
        bytes_out = sum(_nbytes(_val(v)) for v in exports)

        meta: dict[str, Any] = {"n_ops": len(grp),
                                "ops": tuple(_op_name(n) for n in grp),
                                # the group itself, for node-fn codegen
                                # (api._fx_graph): member fx nodes, import
                                # spec (node, dep_index, slot, n_slots),
                                # constants and exports in slot order
                                "_fx_nodes": tuple(grp),
                                "_imports": tuple(import_spec),
                                "_consts": dict(const_bindings),
                                "_exports": tuple(exports)}
        rows = _gemm_rows(anchor_op)
        if rows is not None:
            meta["rows"] = rows

        kind = _kind_of(anchor_op)
        g.add_op(
            node_name,
            kind="elementwise" if kind == "movement" else kind,
            flops=flops,
            bytes_in=bytes_in,
            bytes_out=bytes_out,
            deps=tuple(dep_names),
            meta=meta,
            fn=_make_node_fn(grp, import_spec, const_bindings, exports),
        )
        for slot, v in enumerate(exports):
            home[v] = (node_name, slot, len(exports))

    # the full output leaf list: traced tensors interleaved with constants
    out_spec: list[tuple] = []
    tensor_outs = iter(out_nodes)
    n_out = len(out_nodes) + len(box["consts"])
    for j in range(n_out):
        if j in box["consts"]:
            out_spec.append(("const", box["consts"][j]))
            continue
        v = next(tensor_outs)
        if v in placeholder_leaf:
            out_spec.append(("input", placeholder_leaf[v]))
        elif v in home:
            out_spec.append(("node", *home[v]))
        elif v in consts:
            out_spec.append(("const", consts[v]))
        else:
            raise ValueError(f"capture({gname}): unplaced output {v}")

    g.validate()
    return CapturedGraph(
        graph=g,
        name=gname,
        in_tree=in_tree,
        n_in_leaves=len(leaves),
        input_names=input_names,
        out_tree=box["out_tree"],
        out_spec=out_spec,
        n_ops=len(ops),
        gm=gm,
    )
