"""Cell builder: (architecture x input shape x mesh) -> one rank's program —
the port of the JAX package's ``launch/cells.py``.

A *cell* is one entry of the 40-cell dry-run matrix.  ``build_cell``
describes it without allocating anything: the step function over DTensor
trees, the abstract (fake) argument trees at global shapes, and their
specs.  :func:`rank_program` turns a cell into the program one rank runs —
a function of the rank's *local* shards that wraps them into DTensors,
runs the step under the cell's mesh context and returns its local outputs
— which the dry-run traces under fake tensors (the counterpart of the
reference's ``lower().compile()``) and, on the card, runs.

Per-cell execution plans (microbatching, sequence-parallel activations,
ZeRO-3) live in ``plan_for``; its HBM budget is 0.75 of an H100's 80 GB,
the reference's 12 GB / 16 GB ratio.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.analysis.roofline import H100_SXM
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, get_config
from repro_torch.dist.sharding import (MeshCtx, batch_axes, batch_pspecs, cache_pspecs,
                                       param_pspecs, placements, state_pspecs,
                                       tree_map_with_path, use_mesh)
from repro_torch.dist.train import spec_at

__all__ = ["CellPlan", "Cell", "plan_for", "build_cell", "cell_matrix", "served_archs",
           "skip_reason", "rank_program", "rank_inputs", "HBM_BUDGET", "FULL_ATTENTION_ARCHS"]

# archs whose every block attends over the full context: long_500k (524k
# decode) is quadratic-cost / unbounded-cache for them -> skipped
FULL_ATTENTION_ARCHS = {
    "gemma-2b",
    "yi-9b",
    "command-r-plus-104b",
    "llava-next-34b",
    "olmoe-1b-7b",
    "granite-moe-1b-a400m",
    "whisper-medium",
}

HBM_BUDGET = 0.75 * H100_SXM.hbm_bytes     # the reference's 12e9 / 16e9 of its HBM


@dataclass(frozen=True)
class CellPlan:
    """Tunable execution plan for one cell (the perf-pass knobs)."""

    microbatches: int = 1
    seq_shard: bool = False       # Megatron-SP residual-stream seq sharding
    remat: bool = True
    fsdp: bool = False            # ZeRO-3 param/moment sharding over 'data'
    extra: dict = field(default_factory=dict)

    def override(self, **kw: Any) -> "CellPlan":
        return replace(self, **kw)


def plan_for(
    cfg: ModelConfig, shape: ShapeSpec, mesh: Any, *, hbm_budget: float = HBM_BUDGET
) -> CellPlan:
    """Baseline plan: fewest microbatches whose estimated footprint fits HBM
    (the budget leaves headroom for fragmentation and temporaries; the
    dry-run checks the traced peak and bumps on overflow).

    Footprint model (per rank):
      fixed  = params x (2 bf16 + 8 fp32 moments + 4 fp32 grads) / tp
      per-mb = tokens_mb x [ 3 dtype-bytes x Vp/tp   (logits + its grad)
                           + L x D x 2 / sp          (remat layer carries)
                           + ~12 x D x 2 / sp ]      (within-layer working set)
    """
    if shape.kind == "decode":
        return CellPlan(microbatches=1, seq_shard=False, remat=False)
    tp = mesh.shape.get("model", 1)
    dp = 1
    for a in batch_axes(mesh, shape.global_batch):
        dp *= mesh.shape[a]
    seq_shard = shape.seq_len >= 2048 and shape.seq_len % tp == 0
    sp = tp if seq_shard else 1

    params = cfg.n_params()
    state_bytes = 2 + 8 + 4 if shape.kind == "train" else 2
    fixed = params * state_bytes / tp
    # ZeRO-3 when the parameter/optimizer footprint alone would crowd HBM
    fsdp = fixed > hbm_budget * 0.5
    if fsdp:
        fixed /= max(dp, 1)
    B, S, D, L = shape.global_batch, shape.seq_len, cfg.d_model, cfg.n_layers
    Vp = cfg.padded_vocab

    def per_mb_bytes(mb: int) -> float:
        tokens = (B // mb // dp) * S
        logits = tokens * (Vp / tp) * 4 * 3
        carries = tokens * L * D * 2 / sp
        working = tokens * 12 * D * 2 / sp
        return logits + carries + working

    mb = 1
    # cap: each microbatch must still divide the dp axes, or activations
    # silently replicate over 'data' and memory goes UP
    mb_cap = max(1, B // max(dp, 1))
    if shape.kind == "train":
        while (
            mb * 2 <= mb_cap
            and B % (mb * 2) == 0
            and fixed + per_mb_bytes(mb) > hbm_budget
        ):
            mb *= 2
    return CellPlan(
        microbatches=mb, seq_shard=seq_shard, remat=shape.kind == "train", fsdp=fsdp
    )


def skip_reason(arch: str, shape_name: str) -> str | None:
    canon = arch.replace("_", "-")
    if shape_name == "long_500k" and canon in FULL_ATTENTION_ARCHS:
        return "full-attention arch: 524k decode is unbounded-cache/quadratic"
    return None


@dataclass
class Cell:
    arch: str
    shape_name: str
    cfg: ModelConfig
    shape: ShapeSpec
    plan: CellPlan
    kind: str                      # train | prefill | decode
    fn: Callable                   # the step over DTensor trees
    args: tuple                    # abstract (fake) argument trees, global shapes
    specs: tuple                   # a spec tree per argument
    ctx: MeshCtx
    mesh: Any


def _fake_args(cfg: ModelConfig, shape: ShapeSpec, kind: str, plan: CellPlan) -> tuple:
    """The step's arguments as fake tensors at global shapes (nothing is
    allocated), built on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import param_specs

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = param_specs(cfg, device="cpu", fake_mode=mode)
    if kind == "train":
        with mode:
            state = {"params": params, **adamw_init(params)}
        batch = model_api.input_specs(cfg, shape, kind="train", device="cpu", fake_mode=mode)
        return state, batch
    with mode:
        cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
    if kind == "prefill":
        batch = model_api.input_specs(cfg, shape, kind="prefill", device="cpu", fake_mode=mode)
        return params, cache, batch
    tokens = model_api.input_specs(cfg, shape, kind="decode", device="cpu", fake_mode=mode)
    return params, cache, tokens["tokens"]


def build_cell(
    arch: str,
    shape_name: str,
    mesh: Any,
    *,
    plan: CellPlan | None = None,
    smoke: bool = False,
    n_layers: int | None = None,
) -> Cell:
    """The cell's step, abstract arguments and specs.  ``n_layers`` cuts the
    depth (the widths stay the config's)."""
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = cfg.reduced(n_layers=n_layers)
    shape = SHAPES[shape_name]
    plan = plan or plan_for(cfg, shape, mesh)
    if plan.extra:
        cfg = cfg.reduced(**plan.extra)
    kind = shape.kind
    B = shape.global_batch
    ctx = MeshCtx(mesh, batch_axes(mesh, B), seq="model" if plan.seq_shard else None)
    args = _fake_args(cfg, shape, kind, plan)
    if kind == "train":
        tcfg = TrainStepConfig(microbatches=plan.microbatches, remat=plan.remat)
        specs = (state_pspecs(cfg, args[0], mesh, fsdp=plan.fsdp),
                 batch_pspecs(args[1], mesh, B))
        fn = make_train_step(cfg, tcfg)
    else:
        p_spec = param_pspecs(cfg, args[0], mesh, fsdp=plan.fsdp)
        c_spec = cache_pspecs(cfg, args[1], mesh, B)
        if kind == "prefill":
            specs = (p_spec, c_spec, batch_pspecs(args[2], mesh, B))
            fn = make_prefill_step(cfg)
        else:
            specs = (p_spec, c_spec, batch_pspecs({"tokens": args[2]}, mesh, B)["tokens"])
            fn = make_decode_step(cfg)
    return Cell(arch, shape_name, cfg, shape, plan, kind, fn, args, specs, ctx, mesh)


def served_archs() -> list[str]:
    """The archs of the dry-run's matrix: those the port serves as well as
    trains (a latent-attention arch trains only, so it has no prefill or
    decode cell)."""
    from repro_torch.configs.base import get_config, list_archs
    from repro_torch.models.transformer import serving_supported

    return [a.replace("_", "-") for a in list_archs() if serving_supported(get_config(a))]


def cell_matrix(archs: list[str] | None = None) -> list[tuple[str, str]]:
    """The full 40-cell (arch x shape) matrix of :func:`served_archs`,
    including skipped cells."""
    archs = archs or served_archs()
    return [(a, s) for a in archs for s in SHAPES]


# ---------------------------------------------------------------------------
# one rank's program
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Leaf:
    path: tuple
    shape: tuple[int, ...]          # global
    local: tuple[int, ...]          # this rank's shard
    dtype: torch.dtype
    placements: tuple


def _local_shape(shape: tuple[int, ...], pls: tuple, mesh: Any) -> tuple[int, ...]:
    out = list(shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            out[p.dim] //= mesh.shape[mesh.axis_names[i]]
    return tuple(out)


def _leaves(cell: Cell) -> tuple[list[_Leaf], Any]:
    trees = cell.args
    leaves: list[_Leaf] = []

    def one(path, leaf):
        pls = placements(spec_at(cell.specs, path), cell.mesh)
        leaves.append(_Leaf(path, tuple(leaf.shape), _local_shape(tuple(leaf.shape), pls,
                                                                     cell.mesh),
                            leaf.dtype, pls))
        return leaf

    tree_map_with_path(one, trees)
    return leaves, pytree.tree_structure(trees)


def rank_program(cell: Cell, device_mesh) -> Callable:
    """``program(*local_tensors) -> [local outputs]``: one rank's step.  The
    inputs are this rank's shards of the cell's arguments in
    :func:`rank_inputs`' order; every DTensor output comes back as its
    local tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    leaves, treedef = _leaves(cell)

    def program(*local: torch.Tensor) -> list:
        wrapped = [DTensor.from_local(t, device_mesh, lf.placements, run_check=False,
                                      shape=torch.Size(lf.shape),
                                      stride=_contiguous_stride(lf.shape))
                   for t, lf in zip(local, leaves)]
        args = pytree.tree_unflatten(wrapped, treedef)
        with use_mesh(cell.ctx), implicit_replication():
            out = cell.fn(*args)
        return [x.to_local() if isinstance(x, DTensor) else x
                for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]

    program.__name__ = f"{cell.arch}.{cell.shape_name}.rank"
    return program


def _contiguous_stride(shape: tuple[int, ...]) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def rank_inputs(cell: Cell, device: str | torch.device, *, seed: int = 0,
                fake: bool = False) -> list[torch.Tensor]:
    """This rank's shards of the cell's arguments on ``device``: random
    weights and activations (0.02 scale) from ``seed``, zero moments, tokens
    and labels below the vocabulary, and a decode cache whose every entry is
    live (positions 0..S-1, the step at S-1).  ``fake=True`` makes them
    fake tensors (nothing allocated): the dry-run's trace inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    leaves, _ = _leaves(cell)
    vocab = cell.cfg.vocab_size
    S = cell.shape.seq_len

    def make(lf: _Leaf, gen) -> torch.Tensor:
        name = next((k for k in reversed(lf.path) if isinstance(k, str)), "")
        dev = torch.device(device)
        if lf.dtype in (torch.int32, torch.int64):
            if name == "pos":
                return torch.arange(math.prod(lf.local), dtype=lf.dtype,
                                    device=dev).reshape(lf.local) % S
            if name in ("len", "step"):
                return torch.full(lf.local, S - 1 if name == "len" else 0, dtype=lf.dtype,
                                  device=dev)
            return torch.randint(0, vocab, lf.local, generator=gen, device=dev, dtype=lf.dtype)
        if lf.path[:1] in (("m",), ("v",)):
            return torch.zeros(lf.local, dtype=lf.dtype, device=dev)
        return (torch.randn(lf.local, generator=gen, device=dev, dtype=torch.float32)
                * 0.02).to(lf.dtype)

    if fake:
        with FakeTensorMode(allow_non_fake_inputs=True):
            return [torch.empty(lf.local, dtype=lf.dtype, device=device) for lf in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    return [make(lf, gen) for lf in leaves]
