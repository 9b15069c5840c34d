"""The paper's four evaluation networks as computation graphs (Table 1).

These drive every paper-table reproduction benchmark: the graphs carry the
roofline statistics (flops / bytes per op, fp32 as on KNL+MKL) that the cost
model turns into per-op durations, and the DAG structure the schedulers
exploit.  Sizes follow Table 1 exactly:

* LSTM / PhasedLSTM (1a): seq x neurons = 20x128 / 30x512 / 40x1024, batch 64,
  4 layers (§7.3), PTB-style V=10k softmax head ([65] / TF benchmark).
* PathNet (1b): image x neurons = 32x16 / 48x32 / 64x48, batch 64; 3 layers,
  6 active modules/layer, each module conv3x3 -> relu -> pool2x2 (§7.1).
* GoogleNet (1c): image x width = 128x1 / 192x2 / 256x4, batch 32; the
  standard 9-inception-module network [58] with every filter count x width.

``training_graph`` mirrors a forward graph with backward ops (reverse deps,
~2x flops — dX and dW each cost about one forward pass), reproducing the
paper's observation that backward doubles the available parallelism.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph, OpNode

__all__ = [
    "PAPER_NETS",
    "PAPER_SIZES",
    "paper_graph",
    "training_graph",
    "lstm_forward_graph",
    "pathnet_forward_graph",
    "googlenet_forward_graph",
]

F32 = 4  # bytes; the paper's MKL/LIBXSMM path is single precision

PAPER_NETS = ("lstm", "phased_lstm", "pathnet", "googlenet")

# Table 1 parameters: net -> size -> (primary, secondary)
PAPER_SIZES: dict[str, dict[str, tuple[int, int]]] = {
    "lstm": {"small": (20, 128), "medium": (30, 512), "large": (40, 1024)},
    "phased_lstm": {"small": (20, 128), "medium": (30, 512), "large": (40, 1024)},
    "pathnet": {"small": (32, 16), "medium": (48, 32), "large": (64, 48)},
    "googlenet": {"small": (128, 1), "medium": (192, 2), "large": (256, 4)},
}

PAPER_BATCH = {"lstm": 64, "phased_lstm": 64, "pathnet": 64, "googlenet": 32}

LSTM_LAYERS = 4
LSTM_VOCAB = 10_000       # PTB softmax head ([65])
PATHNET_LAYERS = 3
PATHNET_MODULES = 6
PATHNET_CLASSES = 10


# ---------------------------------------------------------------------------
# node helpers (fp32 roofline stats)
# ---------------------------------------------------------------------------

def _gemm(g: Graph, name: str, M: int, K: int, N: int, deps=()) -> OpNode:
    return g.add_op(
        name, kind="gemm",
        flops=2.0 * M * K * N,
        bytes_in=(M * K + K * N) * F32,
        bytes_out=M * N * F32,
        deps=tuple(deps),
        meta={"rows": M, "mnk": (M, N, K)},
    )


def _conv(
    g: Graph, name: str, B: int, H: int, W: int, Cin: int, Cout: int,
    k: int, stride: int = 1, deps=(),
) -> OpNode:
    Ho, Wo = H // stride, W // stride
    return g.add_op(
        name, kind="conv",
        flops=2.0 * B * Ho * Wo * Cout * Cin * k * k,
        bytes_in=(B * H * W * Cin + Cin * Cout * k * k) * F32,
        bytes_out=B * Ho * Wo * Cout * F32,
        deps=tuple(deps),
        meta={"out_hw": (Ho, Wo), "out_c": Cout},
    )


def _ew(g: Graph, name: str, numel: int, ops_per_elt: float = 1.0, deps=(), n_in: int = 1) -> OpNode:
    return g.add_op(
        name, kind="elementwise",
        flops=ops_per_elt * numel,
        bytes_in=n_in * numel * F32,
        bytes_out=numel * F32,
        deps=tuple(deps),
    )


def _pool(g: Graph, name: str, B: int, H: int, W: int, C: int, k: int, stride: int, deps=()) -> OpNode:
    Ho, Wo = H // stride, W // stride
    return g.add_op(
        name, kind="pool",
        flops=float(B * Ho * Wo * C * k * k),
        bytes_in=B * H * W * C * F32,
        bytes_out=B * Ho * Wo * C * F32,
        deps=tuple(deps),
        meta={"out_hw": (Ho, Wo), "out_c": C},
    )


# ---------------------------------------------------------------------------
# LSTM / PhasedLSTM
# ---------------------------------------------------------------------------

def lstm_forward_graph(size: str, *, phased: bool = False, batch: int | None = None) -> Graph:
    """4-layer (Phased)LSTM unrolled over the sequence.

    Per cell (l,t): two GEMMs [B,H]x[H,4H] (input & recurrent — independent,
    the paper's "2-3 parallel operators in each cell") feeding one fused
    gate/elementwise op.  PhasedLSTM adds the time-gate elementwise op (k/phi
    oscillation masks) per cell — same GEMMs, slightly wider graph.
    """
    T, H = PAPER_SIZES["phased_lstm" if phased else "lstm"][size]
    B = batch or PAPER_BATCH["lstm"]
    name = ("phased_lstm" if phased else "lstm") + f"_{size}"
    g = Graph(name)
    for t in range(T):
        g.add_op(f"x_T{t}", kind="input", bytes_out=B * H * F32)
    cell_out: dict[tuple[int, int], str] = {}
    for t in range(T):
        for l in range(LSTM_LAYERS):
            below = f"x_T{t}" if l == 0 else cell_out[(l - 1, t)]
            gx = _gemm(g, f"gx_L{l}_T{t}", B, H, 4 * H, deps=[below])
            hdeps = [cell_out[(l, t - 1)]] if t > 0 else []
            gh = _gemm(g, f"gh_L{l}_T{t}", B, H, 4 * H, deps=hdeps)
            # i,f,g,o sigmoid/tanh + cell update: ~8 transcendental-ish ops/elt
            ew = _ew(g, f"ew_L{l}_T{t}", B * 4 * H, 8.0, deps=[gx.name, gh.name], n_in=2)
            out = ew.name
            if phased:
                kg = _ew(g, f"kgate_L{l}_T{t}", B * H, 6.0, deps=[ew.name], n_in=2)
                out = kg.name
            cell_out[(l, t)] = out
            # annotate wavefront coordinates for the cuDNN-diagonal check
            names = {gx.name, gh.name, ew.name, out}
            for nm in names:
                node = g[nm]
                object.__setattr__(node, "meta", {**node.meta, "layer": l, "step": t, "diag": l + t})
    # [65]-style head: concat all top-layer states -> ONE [B*T, H] x [H, V]
    # softmax GEMM (per-step heads would add fake width the real net lacks)
    _ew(g, "concat_h", B * T * H, 0.0,
        deps=[cell_out[(LSTM_LAYERS - 1, t)] for t in range(T)], n_in=1)
    _gemm(g, "softmax", B * T, H, LSTM_VOCAB, deps=["concat_h"])
    _ew(g, "loss", B * T, 2.0, deps=["softmax"])
    return g


# ---------------------------------------------------------------------------
# PathNet
# ---------------------------------------------------------------------------

def pathnet_forward_graph(size: str, *, batch: int | None = None) -> Graph:
    """3 layers x 6 parallel modules; module = conv3x3 -> relu -> pool2x2;
    module outputs of a layer are summed before the next layer (§7.1)."""
    I, N = PAPER_SIZES["pathnet"][size]
    B = batch or PAPER_BATCH["pathnet"]
    g = Graph(f"pathnet_{size}")
    g.add_op("input", kind="input", bytes_out=B * I * I * 3 * F32)
    prev, hw, cin = "input", I, 3
    for l in range(PATHNET_LAYERS):
        outs = []
        for m in range(PATHNET_MODULES):
            c = _conv(g, f"conv_L{l}_M{m}", B, hw, hw, cin, N, 3, deps=[prev])
            r = _ew(g, f"relu_L{l}_M{m}", B * hw * hw * N, 1.0, deps=[c.name])
            p = _pool(g, f"pool_L{l}_M{m}", B, hw, hw, N, 2, 2, deps=[r.name])
            outs.append(p.name)
        hw //= 2
        agg = _ew(g, f"agg_L{l}", B * hw * hw * N, float(PATHNET_MODULES),
                  deps=outs, n_in=PATHNET_MODULES)
        prev, cin = agg.name, N
    _gemm(g, "fc", B, N * hw * hw, PATHNET_CLASSES, deps=[prev])
    _ew(g, "loss", B * PATHNET_CLASSES, 2.0, deps=["fc"])
    return g


# ---------------------------------------------------------------------------
# GoogleNet
# ---------------------------------------------------------------------------

# standard inception filter table [58]: (c1, c3r, c3, c5r, c5, pool_proj)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def googlenet_forward_graph(size: str, *, batch: int | None = None) -> Graph:
    """GoogleNet with every filter count scaled by the Table-1c width
    multiplier.  Each inception module has 4 parallel branches (the paper's
    "2-3 parallel convolution/pooling operations" plus the pool-proj)."""
    I, w = PAPER_SIZES["googlenet"][size]
    B = batch or PAPER_BATCH["googlenet"]
    g = Graph(f"googlenet_{size}")
    g.add_op("input", kind="input", bytes_out=B * I * I * 3 * F32)

    # stem
    c1 = _conv(g, "stem_conv7", B, I, I, 3, 64 * w, 7, 2, deps=["input"])
    hw = I // 2
    p1 = _pool(g, "stem_pool1", B, hw, hw, 64 * w, 3, 2, deps=[c1.name])
    hw //= 2
    c2 = _conv(g, "stem_conv1", B, hw, hw, 64 * w, 64 * w, 1, deps=[p1.name])
    c3 = _conv(g, "stem_conv3", B, hw, hw, 64 * w, 192 * w, 3, deps=[c2.name])
    p2 = _pool(g, "stem_pool2", B, hw, hw, 192 * w, 3, 2, deps=[c3.name])
    hw //= 2
    prev, cin = p2.name, 192 * w

    for mod, (c1f, c3r, c3f, c5r, c5f, pp) in _INCEPTION.items():
        c1f, c3r, c3f, c5r, c5f, pp = (x * w for x in (c1f, c3r, c3f, c5r, c5f, pp))
        b1 = _conv(g, f"i{mod}_1x1", B, hw, hw, cin, c1f, 1, deps=[prev])
        b2a = _conv(g, f"i{mod}_3x3r", B, hw, hw, cin, c3r, 1, deps=[prev])
        b2 = _conv(g, f"i{mod}_3x3", B, hw, hw, c3r, c3f, 3, deps=[b2a.name])
        b3a = _conv(g, f"i{mod}_5x5r", B, hw, hw, cin, c5r, 1, deps=[prev])
        b3 = _conv(g, f"i{mod}_5x5", B, hw, hw, c5r, c5f, 5, deps=[b3a.name])
        b4a = _pool(g, f"i{mod}_pool", B, hw, hw, cin, 3, 1, deps=[prev])
        b4 = _conv(g, f"i{mod}_poolproj", B, hw, hw, cin, pp, 1, deps=[b4a.name])
        cin = c1f + c3f + c5f + pp
        cat = _ew(g, f"i{mod}_concat", B * hw * hw * cin, 0.0,
                  deps=[b1.name, b2.name, b3.name, b4.name], n_in=1)
        prev = cat.name
        if mod in ("3b", "4e"):
            pl = _pool(g, f"pool_after_{mod}", B, hw, hw, cin, 3, 2, deps=[prev])
            hw //= 2
            prev = pl.name

    ap = _pool(g, "avgpool", B, hw, hw, cin, hw, hw, deps=[prev])
    _gemm(g, "fc", B, cin, 1000, deps=[ap.name])
    _ew(g, "loss", B * 1000, 2.0, deps=["fc"])
    return g


# ---------------------------------------------------------------------------
# forward -> training graph
# ---------------------------------------------------------------------------

def training_graph(fwd: Graph, *, bwd_flops_ratio: float = 2.0) -> Graph:
    """Mirror a forward graph with backward ops.

    d_<op> depends on every d_<successor> (reverse data flow) plus <op>
    itself (its saved activations).  Costs: backward of one op computes both
    dX and dW — about 2x the forward flops, same traffic class.  Sources
    (inputs) get no backward node; the loss's backward seeds the sweep.
    """
    g = Graph(fwd.name + "_train")
    for n in fwd.topo_order():
        node = fwd[n]
        g.add(OpNode(
            name=node.name, kind=node.kind, flops=node.flops,
            bytes_in=node.bytes_in, bytes_out=node.bytes_out,
            deps=node.deps, meta=dict(node.meta),
        ))
    for n in reversed(fwd.topo_order()):
        node = fwd[n]
        if node.kind == "input":
            continue
        succs = [s for s in fwd.successors(n) if fwd[s].kind != "input"]
        deps = [f"d_{s}" for s in succs if f"d_{s}" in g] + [n]
        g.add(OpNode(
            name=f"d_{n}", kind=node.kind,
            flops=node.flops * bwd_flops_ratio,
            bytes_in=node.bytes_in + node.bytes_out,
            bytes_out=node.bytes_in,
            deps=tuple(deps),
            meta={**dict(node.meta), "backward": True},
        ))
    return g


def paper_graph(net: str, size: str, *, training: bool = True, batch: int | None = None) -> Graph:
    """Registry entry: Table-1 network graph (training by default — one
    complete execution = one training iteration, §2)."""
    if net == "lstm":
        fwd = lstm_forward_graph(size, phased=False, batch=batch)
    elif net == "phased_lstm":
        fwd = lstm_forward_graph(size, phased=True, batch=batch)
    elif net == "pathnet":
        fwd = pathnet_forward_graph(size, batch=batch)
    elif net == "googlenet":
        fwd = googlenet_forward_graph(size, batch=batch)
    else:
        raise ValueError(f"unknown paper net {net!r} (one of {PAPER_NETS})")
    return training_graph(fwd) if training else fwd
