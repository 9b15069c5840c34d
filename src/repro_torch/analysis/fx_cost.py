"""Cost walker over a traced fx graph — the port of the JAX package's
``analysis/hlo_cost.py`` (which walks optimized HLO text), named after what
it reads: the ``torch.fx`` graph that ``make_fx(tracing_mode="fake")``
records (``core/capture.py``'s trace; :func:`trace` here).

``make_fx`` unrolls every Python loop (layers, microbatches, chunks), so
there are no trip counts to multiply: a loop of N matmuls reads as N
matmul nodes.  Accounting conventions (per rank — a sharded step traces as
one rank's program, its collectives as ``_c10d_functional`` nodes):

* flops: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` = 2·M·N·K; convolution
  = 2·|out|·(C_in / groups)·|kernel|; elementwise = |out|; reductions =
  |input|; views and metadata = 0.  Each kernel's custom op (B1–B7 and the
  backwards) by its own formula below — the same functions chip_smoke's
  bounds call, one copy;
* bytes: per op = operand bytes + result bytes (an HBM-traffic model);
  views move nothing;
* collectives: operand bytes per kind.

:func:`peak_bytes` is the trace's tracked peak: the inputs resident, each
result allocated at its node and freed after its last reader (views alias
their base).
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["ModuleCost", "module_cost", "trace", "peak_bytes", "COLLECTIVE_KINDS",
           "flash_pairs", "flash_work", "flash_bwd_work", "dense_decode_work",
           "paged_decode_work", "lstm_cell_work", "lstm_cell_bwd_work", "moe_gmm_work",
           "moe_gmm_bwd_work", "moe_route_work", "scan_work", "bound_ms"]

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# views and metadata: no flops, no traffic (their readers pay for the data)
_FREE_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose", "unsqueeze",
    "squeeze", "select", "slice", "alias", "as_strided", "detach", "split", "split_with_sizes",
    "unbind", "chunk", "view_as_real", "view_as_complex", "lift_fresh_copy", "_to_copy_view",
    "sym_size", "sym_stride", "sym_numel", "wait_tensor", "getitem", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "scalar_tensor", "arange", "zeros",
    "zeros_like", "full", "ones", "ones_like", "full_like", "_local_scalar_dense",
}
_VIEW_OPS = {"view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose",
             "unsqueeze", "squeeze", "select", "slice", "alias", "as_strided", "detach",
             "split", "split_with_sizes", "unbind", "chunk", "getitem", "wait_tensor"}
# data movement: bytes but no flops
_MOVE_OPS = {
    "clone", "copy", "copy_", "_to_copy", "contiguous", "cat", "stack", "index", "index_select",
    "gather", "scatter", "index_put", "index_copy", "index_fill", "masked_fill", "where",
    "constant_pad_nd", "flip", "roll", "repeat", "embedding", "embedding_dense_backward",
    "select_scatter", "slice_scatter", "new_zeros", "tril", "triu", "fill", "fill_",
}
_REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "logsumexp",
               "_log_softmax", "_softmax", "argmax", "argmin", "topk", "var", "std", "any",
               "all", "norm", "linalg_vector_norm", "_log_softmax_backward_data",
               "_softmax_backward_data", "sort"}

HBM_BYTES_PER_S = 3.35e12       # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12             # H100 SXM published dense bf16 rate
F32_FLOPS = 67e12               # H100 SXM published f32 rate outside the tensor cores


@dataclass
class ModuleCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict[str, tuple[int, float]] = field(default_factory=dict)
    kernel_calls: dict[str, int] = field(default_factory=dict)
    unknown_ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(b for _, b in self.collectives.values())


# ---------------------------------------------------------------------------
# the kernels' work formulas (chip_smoke's bounds call these)
# ---------------------------------------------------------------------------

def bound_ms(flops: float, nbytes: float, rate: float) -> tuple[float, str]:
    """Least time for ``nbytes`` over the HBM rate or ``flops`` over
    ``rate``, whichever is larger: ``(ms, "bytes" | "operations")``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int | None, q_offset: int = 0) -> int:
    """(query, key) pairs B3 keeps for one row block: key j for query row i
    when ``j <= i + q_offset`` (causal) and ``i + q_offset - j < window``."""
    if not causal and window is None:
        return Sq * Skv
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, Skv) if causal else np.full(Sq, Skv, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(B, Sq, Skv, Hq, Hkv, hd, itemsize, pairs) -> tuple[float, float]:
    """B3's forward: q, k, v read once and the output written once; the
    kept pairs' two products.  ``(flops, bytes)``."""
    nbytes = (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd) * itemsize
    return 4.0 * B * pairs * Hq * hd, float(nbytes)


def flash_bwd_work(B, Sq, Skv, Hq, Hkv, hd, itemsize, pairs) -> tuple[float, float]:
    """B3's backward: q, k, v, out, dout and lse read once, dq, dk, dv
    written once; the kept pairs' five products (P recomputed, dP, dV, dK,
    dQ: 10 flops a pair a head-dim element)."""
    nbytes = (4 * B * Sq * Hq * hd + 4 * B * Skv * Hkv * hd) * itemsize + 4 * B * Hq * Sq
    return 10.0 * B * pairs * Hq * hd, float(nbytes)


def dense_decode_work(B, Hq, Hkv, hd, S, itemsize, entries, empty_rows, n_pos, n_qpos):
    """B2: the K/V entries the rows keep (each read once), all of V for a
    row that keeps none (its output is the mean of V), q, kv_pos, q_pos and
    the output."""
    kv = (2 * entries + empty_rows * S) * Hkv * hd * itemsize
    io = 2 * B * Hq * hd * itemsize + 4 * (n_pos + n_qpos)
    return 4.0 * entries * Hq * hd + empty_rows * S * Hkv * hd, float(kv + io)


def paged_decode_work(B, Hq, hd, itemsize, entries, kv_bytes, n_table, n_qpos):
    """B1: ``kv_bytes`` of distinct pages the live rows need (the caller
    counts them), q, the table, q_pos and the output."""
    io = 2 * B * Hq * hd * itemsize + n_table * 4 + n_qpos * 4
    return 4.0 * entries * Hq * hd, float(kv_bytes + io)


def lstm_cell_work(N, H, g_item, b_numel, b_item, c_item):
    """B4: gx, gh, b and c read once, h and c' written once; ~8 ops per gate
    element."""
    nbytes = (2 * N * 4 * H * g_item + b_numel * b_item + 2 * N * H * c_item + N * H * g_item)
    return 8.0 * N * 4 * H, float(nbytes)


def lstm_cell_bwd_work(N, H, g_item, c_item):
    """B4's backward: gx, gh, b, c, dh and dc read once, dgates and dc_prev
    written once; ~30 ops per element of h."""
    nbytes = 3 * N * 4 * H * g_item + 4 * H * g_item + N * H * (g_item + 3 * c_item)
    return 30.0 * N * H, float(nbytes)


def moe_gmm_work(E, C, D, F, itemsize):
    """B5: x and w read once and the output written once; 2·E·C·D·F."""
    return 2.0 * E * C * D * F, float((E * C * D + E * D * F + E * C * F) * itemsize)


def moe_gmm_bwd_work(E, C, D, F, itemsize):
    """B5's backward: x, w and dy read once, dx and dw written once; the two
    products' 4·E·C·D·F."""
    return 4.0 * E * C * D * F, float((2 * (E * C * D + E * D * F) + E * C * F) * itemsize)


def moe_route_work(G, Tg, k, E, C):
    """MoE routing's slot assignment: the int64 expert ids read once, the
    int64 positions, bool keep, int64 slot table ``[G, E, C + 1]`` and
    counts ``[G, E]`` written once; one rank a claim."""
    claims = G * Tg * k
    return float(claims), float(claims * (8 + 8 + 1) + 8 * G * E * (C + 2))


def scan_work(tensors, flops: float):
    """A scan (B6 / B7 and their backwards): every input and output once."""
    return flops, float(sum(t.numel() * t.element_size() for t in tensors if t is not None))


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

def _name(node: torch.fx.Node) -> str:
    t = node.target
    if t is operator.getitem:
        return "getitem"
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(t, "__name__", str(t))


def _val(x: Any) -> Any:
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else x


def _n(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return int(np.prod([int(d) for d in t.shape])) if t.dim() else 1
    if isinstance(t, (tuple, list)):
        return sum(_n(v) for v in t)
    return 0


def _bytes(t: Any) -> float:
    if isinstance(t, torch.Tensor):
        return float(_n(t) * t.element_size())
    if isinstance(t, (tuple, list)):
        return sum(_bytes(v) for v in t)
    return 0.0


def _io_bytes(node: torch.fx.Node) -> float:
    ins = sum(_bytes(_val(a)) for a in node.all_input_nodes)
    return ins + _bytes(_val(node))


def _kernel_cost(name: str, node: torch.fx.Node) -> tuple[float, float] | None:
    """(flops, bytes) of a kernel op by its own formula; None for others.
    Data-dependent counts (kept decode entries) take the structural most."""
    a = [_val(x) for x in node.args]
    if name in ("flash_attention", "flash_attention_train"):
        q, k = a[0], a[1]
        B, Sq, Hq, hd = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        pairs = flash_pairs(int(Sq), int(Skv), bool(a[3]), a[4], int(a[5]))
        return flash_work(B, Sq, Skv, Hq, Hkv, hd, q.element_size(), pairs)
    if name == "flash_attention_bwd":
        q, k = a[1], a[2]
        B, Sq, Hq, hd = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        pairs = flash_pairs(int(Sq), int(Skv), bool(a[6]), a[7], int(a[8]))
        return flash_bwd_work(B, Sq, Skv, Hq, Hkv, hd, q.element_size(), pairs)
    if name in ("decode_attention", "decode_attention_lse"):
        q, k, pos, qp = a[0], a[1], a[3], a[4]
        B, Hq, hd = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        return dense_decode_work(B, Hq, Hkv, hd, S, q.element_size(), B * S, 0, _n(pos), _n(qp))
    if name == "paged_decode_attention":
        q, kp, table, qp = a[0], a[1], a[3], a[4]
        B, Hq, hd = q.shape
        P, ps, Hkv, _ = kp.shape
        entries = min(int(B * table.shape[1] * ps), int(P * ps) * B)
        kv = 2 * min(entries, int(P * ps)) * Hkv * hd * kp.element_size()
        return paged_decode_work(B, Hq, hd, q.element_size(), entries, kv, _n(table), _n(qp))
    if name == "lstm_cell":
        gx, b, c = a[0], a[2], a[3]
        N, H = c.shape
        return lstm_cell_work(N, H, gx.element_size(), _n(b), b.element_size(), c.element_size())
    if name == "lstm_cell_bwd":
        gx, c = a[0], a[3]
        N, H = c.shape
        return lstm_cell_bwd_work(N, H, gx.element_size(), c.element_size())
    if name in ("moe_gmm", "moe_gmm_bwd"):
        x, w = a[0], a[1]
        E, C, D = x.shape
        F = w.shape[2]
        fn = moe_gmm_work if name == "moe_gmm" else moe_gmm_bwd_work
        return fn(E, C, D, F, x.element_size())
    if name == "moe_route_slots":
        G, Tg, k = (int(d) for d in a[0].shape)
        return moe_route_work(G, Tg, k, int(a[1]), int(a[2]))
    scan_flops = {"ssm_scan": 4.0, "ssm_scan_train": 4.0, "rglru_scan": 2.0,
                  "ssm_scan_bwd": 8.0, "rglru_scan_bwd": 3.0}
    if name in scan_flops:
        outs = _val(node)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        tensors = [t for t in a if isinstance(t, torch.Tensor)] + outs
        return scan_work(tensors, scan_flops[name] * _n(a[0]))
    return None


def _gemm_flops(name: str, node: torch.fx.Node) -> float | None:
    out = _val(node)
    if name in ("mm", "bmm"):
        return 2.0 * _n(out) * int(_val(node.args[0]).shape[-1])
    if name in ("addmm", "baddbmm"):
        return 2.0 * _n(out) * int(_val(node.args[1]).shape[-1])
    if name == "convolution":           # w [C_out, C_in / groups, *kernel]
        w = _val(node.args[1])
        return 2.0 * _n(out) * int(np.prod([int(d) for d in w.shape[1:]]))
    return None


def module_cost(gm: torch.fx.GraphModule) -> ModuleCost:
    """Per-rank flops / HBM bytes / collective traffic of a traced graph."""
    mc = ModuleCost()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _name(node)
        ns = str(getattr(node.target, "namespace", ""))
        if ns in ("_c10d_functional", "c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            c, b = mc.collectives.get(kind, (0, 0.0))
            payload = sum(_bytes(_val(x)) for x in node.all_input_nodes)
            mc.collectives[kind] = (c + 1, b + payload)
            continue
        kern = _kernel_cost(name, node) if ns == "repro_torch" else None
        if kern is not None:
            mc.flops += kern[0]
            mc.bytes += kern[1]
            mc.kernel_calls[name] = mc.kernel_calls.get(name, 0) + 1
            continue
        if name in _FREE_OPS:
            continue
        gf = _gemm_flops(name, node)
        if gf is not None:
            mc.flops += gf
        elif name in _MOVE_OPS:
            pass
        elif name in _REDUCE_OPS:
            ins = [_val(x) for x in node.all_input_nodes]
            mc.flops += _n(ins[0]) if ins else 0.0
        else:
            if ns not in ("aten", "prims"):
                mc.unknown_ops += 1
            mc.flops += _n(_val(node))
        mc.bytes += _io_bytes(node)
    return mc


def peak_bytes(gm: torch.fx.GraphModule) -> float:
    """The tracked peak of a traced program: its inputs resident throughout,
    each result allocated at its node and freed after its last reader.  A
    view allocates nothing and keeps its base alive as long as it is read."""
    nodes = list(gm.graph.nodes)
    base: dict[torch.fx.Node, torch.fx.Node] = {}
    last: dict[torch.fx.Node, int] = {}
    for i, node in enumerate(nodes):
        if node.op == "call_function" and _name(node) in _VIEW_OPS and node.all_input_nodes:
            src = node.all_input_nodes[0]
            base[node] = base.get(src, src)
        for a in node.all_input_nodes:
            r = base.get(a, a)
            last[r] = i
    live = sum(_bytes(_val(n)) for n in nodes if n.op == "placeholder")
    peak = live
    frees: dict[int, float] = {}
    for n, i in last.items():
        if n.op != "placeholder":
            frees[i] = frees.get(i, 0.0) + _bytes(_val(n))
    for i, node in enumerate(nodes):
        if node.op == "call_function" and node not in base:
            live += _bytes(_val(node))
            peak = max(peak, live)
        live -= frees.get(i, 0.0)
    return peak


def trace(fn: Callable, *args: Any) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="fake")(*args)``: shapes and dtypes only,
    nothing runs on a device.  ``args`` are tensors (pytrees flatten)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn, tracing_mode="fake")(*args)
    gm.graph.eliminate_dead_code()
    return gm
