"""Wavefront (anti-diagonal) structure of recurrent computation graphs.

A stacked recurrence (L layers × T timesteps; cell (l,t) depends on (l-1,t)
and (l,t-1)) admits exactly one maximal parallel pattern: all cells on an
anti-diagonal d = l + t are independent.  cuDNN hand-codes this for LSTM; the
paper's headline scheduling result (§7.4) is that critical-path-first
scheduling *recovers it automatically*.  This module provides:

* ``recurrence_graph``   — build the L×T cell DAG (for the scheduler);
* ``diagonals``          — the reference wavefront order;
* ``is_wavefront_order`` — checker used by tests and ``chip_smoke.py``;
* ``lstm_cell`` / ``sequential_lstm`` — the LSTM cell and the layer-by-layer
  interpreter (the JAX package's ``lax.scan`` becomes a Python loop, which
  ``repro_torch.compile`` captures into an L×T graph of cells);
* ``stacked_wavefront_lstm`` — the static plan: all L cells of a diagonal
  stacked on a leading axis, one batched product pair and ONE fused cell
  launch per diagonal.

The cell update runs on kernel B4 (``kernels/lstm_cell``): on the card the
hand-written Hopper kernel, on the CPU its plain version.  The two products
that feed it stay ``torch.matmul`` / ``torch.bmm``, as the JAX package
leaves them to XLA.  Every function takes its device and dtype from its
inputs.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import lstm_cell_fused

from .graph import Graph, OpNode

__all__ = [
    "cell_name",
    "recurrence_graph",
    "diagonals",
    "is_wavefront_order",
    "lstm_cell",
    "stacked_wavefront_lstm",
    "sequential_lstm",
    "params_from_jax",
]


def cell_name(l: int, t: int) -> str:
    return f"cell_L{l}_T{t}"


def recurrence_graph(
    n_layers: int,
    n_steps: int,
    *,
    flops_per_cell: float = 0.0,
    bytes_per_cell: float = 0.0,
    kind: str = "lstm_cell",
) -> Graph:
    """The L×T recurrence DAG with wavefront dependencies."""
    g = Graph(f"recurrence_{n_layers}x{n_steps}")
    for t in range(n_steps):
        for l in range(n_layers):
            deps = []
            if l > 0:
                deps.append(cell_name(l - 1, t))
            if t > 0:
                deps.append(cell_name(l, t - 1))
            g.add(
                OpNode(
                    name=cell_name(l, t),
                    kind=kind,
                    flops=flops_per_cell,
                    bytes_in=bytes_per_cell,
                    bytes_out=bytes_per_cell / 3 if bytes_per_cell else 0.0,
                    deps=tuple(deps),
                    meta={"layer": l, "step": t, "diag": l + t},
                )
            )
    return g


def diagonals(n_layers: int, n_steps: int) -> list[list[tuple[int, int]]]:
    out: list[list[tuple[int, int]]] = []
    for d in range(n_layers + n_steps - 1):
        wave = [(l, d - l) for l in range(n_layers) if 0 <= d - l < n_steps]
        out.append(wave)
    return out


def is_wavefront_order(order: Sequence[str], graph: Graph) -> bool:
    """True iff ops appear in non-decreasing anti-diagonal index."""
    last = -1
    for name in order:
        d = graph[name].meta["diag"]
        if d < last:
            return False
        last = max(last, d)
    return True


# ---------------------------------------------------------------------------
# Real LSTM execution: sequential reference vs stacked-wavefront static plan.
# ---------------------------------------------------------------------------

def lstm_cell(params: Mapping[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard LSTM cell. params: dict(Wx [D,4H], Wh [H,4H], b [4H]).

    The two products are plain ``torch.matmul``; the bias, the gates and
    the state update are one launch of kernel B4."""
    return lstm_cell_fused(x @ params["Wx"], h @ params["Wh"], params["b"], c)


def sequential_lstm(params_per_layer: Sequence[Mapping[str, torch.Tensor]],
                    xs: torch.Tensor) -> torch.Tensor:
    """Reference: layer by layer, step by step (the one-executor interpreter).

    params_per_layer: list of L cell-param dicts (Wx differs for layer 0).
    xs: [T, B, D] input sequence.  Returns top-layer hidden states [T, B, H].
    Cells run layer-major, so the k-th cell call is (l, t) = (k // T, k % T).
    """
    seq = [xs[t] for t in range(xs.shape[0])]
    for lp in params_per_layer:
        B = seq[0].shape[0]
        H = lp["Wh"].shape[0]
        hh = xs.new_zeros((B, H))
        cc = xs.new_zeros((B, H))
        outs = []
        for x in seq:
            hh, cc = lstm_cell(lp, x, hh, cc)
            outs.append(hh)
        seq = outs
    return torch.stack(seq)


def stacked_wavefront_lstm(stacked_params: Mapping[str, torch.Tensor], xs: torch.Tensor,
                           n_layers: int) -> torch.Tensor:
    """The CPF-recovered diagonal schedule as a *static plan* (DESIGN §2.1).

    All L cells of an anti-diagonal execute as ONE stacked cell op: the two
    products as ``torch.baddbmm`` / ``torch.bmm`` over [L, B, ...] and one
    B4 launch over N = L·B rows.  The kernel takes one ``[4H]`` bias row for
    all rows, so the per-layer bias is folded into the input product
    (``baddbmm``) and B4 gets a zero bias.

    Requires homogeneous cell shapes (D == H for layer 0 via an input
    projection done by the caller).  stacked_params: dict of tensors with
    leading layer axis: Wx [L,H,4H], Wh [L,H,4H], b [L,4H].
    xs: [T, B, H].  Returns top-layer hiddens [T, B, H].

    As in the reference, every diagonal computes all L cells and masks the
    inactive ones; the diagonals are Python ints, so the masks are static
    selections, and the emitted top-layer rows are collected out of place.
    """
    T, B, H = xs.shape
    L = n_layers
    Wx, Wh, b = stacked_params["Wx"], stacked_params["Wh"], stacked_params["b"]
    zero = xs.new_zeros((B, H))
    zero_b = b.new_zeros((4 * H,))
    h = xs.new_zeros((L, B, H))        # h[l] = latest hidden of layer l
    c = xs.new_zeros((L, B, H))
    # layer l consumes the *previous* output of layer l-1; keep a shift buffer
    # shifted[l-1] = next input for layer l >= 1 (layer 0 reads the sequence).
    shifted = xs.new_zeros((L - 1, B, H))
    out = []
    for d in range(L + T - 1):
        # feed the sequence into layer 0 when 0 <= d < T
        inbuf = torch.cat([(xs[d] if d < T else zero)[None], shifted])
        gx = torch.baddbmm(b[:, None, :], inbuf, Wx)
        gh = torch.bmm(h, Wh)
        h_new, c_new = lstm_cell_fused(gx.reshape(L * B, 4 * H), gh.reshape(L * B, 4 * H),
                                       zero_b, c.reshape(L * B, H))
        h_new, c_new = h_new.reshape(L, B, H), c_new.reshape(L, B, H)
        # active mask: layer l is live on diagonal d iff 0 <= d - l < T
        active = [0 <= d - l < T for l in range(L)]
        if all(active):
            h, c = h_new, c_new
        else:
            h = torch.stack([h_new[l] if a else h[l] for l, a in enumerate(active)])
            c = torch.stack([c_new[l] if a else c[l] for l, a in enumerate(active)])
        # outputs of layer l feed layer l+1 on the next diagonal
        if all(active[:-1]):
            shifted = h_new[:-1]
        else:
            shifted = torch.stack([h_new[l] if active[l] else zero for l in range(L - 1)])
        # top layer emits position t = d - (L-1)
        if 0 <= d - (L - 1) < T:
            out.append(h_new[L - 1])
    return torch.stack(out)


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_params: Any, *, device: str | torch.device = "cuda") -> Any:
    """LSTM parameters from the JAX package's layout, given as numpy arrays:
    the stacked dict ``{"Wx": [L,H,4H], "Wh": [L,H,4H], "b": [L,4H]}`` of
    :func:`stacked_wavefront_lstm`, or the per-layer list of cell dicts of
    :func:`sequential_lstm`.  Returns the same structure of tensors on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if isinstance(np_params, Mapping):
        return {k: _to_torch(v, dev) for k, v in np_params.items()}
    return [{k: _to_torch(v, dev) for k, v in lp.items()} for lp in np_params]
