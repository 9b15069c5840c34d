"""Rank bodies for the port's gloo tests (``test_torch_dist_ranks.py``).

Each body runs in every rank of a CPU ``gloo`` group spawned by
:func:`launch`; the ranks import torch and the port only (no JAX), and rank
results come back through files.  :func:`launch` kills the ranks and fails
if they outlast their timeout.
"""
from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
from typing import Any

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, bodies: list, payload: Any, out: str,
           path: list) -> None:
    sys.path[:0] = [p for p in path if p not in sys.path]
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        res = {name: globals()[name](rank, world, payload) for name in bodies}
        torch.save(res, os.path.join(out, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(world: int, bodies: list[str], payload: Any, *, timeout: float = 120.0) -> list:
    """Run each body of ``bodies`` (names of functions here) in ``world``
    gloo ranks, in order; returns each rank's ``{body: result}``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_entry, args=(world, _free_port(), bodies, payload, out,
                                               list(sys.path)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"gloo ranks {bodies} outlasted {timeout} s")
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


# ---------------------------------------------------------------------------
# bodies: (rank, world, payload) -> result
# ---------------------------------------------------------------------------

def ring(rank: int, world: int, payload: dict) -> dict:
    """Both ring matmuls on this rank's shards of the payload's x and w."""
    from repro_torch.dist.overlap import ring_allgather_matmul, ring_reducescatter_matmul

    x, w = torch.from_numpy(payload["x"]), torch.from_numpy(payload["w"])
    m, c = x.shape[0] // world, w.shape[1] // world
    ag = ring_allgather_matmul(x[rank * m:(rank + 1) * m], w[:, rank * c:(rank + 1) * c])
    k = x.shape[1] // world
    rs = ring_reducescatter_matmul(x[:, rank * k:(rank + 1) * k], w[rank * k:(rank + 1) * k])
    return {"allgather": ag.numpy(), "reducescatter": rs.numpy()}


def compress(rank: int, world: int, payload: dict) -> dict:
    """``compressed_psum`` of this rank's gradient, once and then repeated
    with error feedback."""
    from repro_torch.dist.compress import compressed_psum

    g = torch.from_numpy(payload["g"][rank])
    err = torch.zeros_like(g)
    means = []
    for _ in range(payload["steps"]):
        mean, err = compressed_psum(g, err, bits=payload["bits"])
        means.append(mean.numpy())
    return {"means": means}


def _float(x) -> float:
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def _smoke_cfg(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True).reduced(dtype=torch.float32)


def train(rank: int, world: int, payload: dict) -> dict:
    """For each arch of the payload: the loss and every gradient of one
    batch, and one train step, through the sharded path on a
    ``payload["mesh"]`` mesh, from the reference's weights."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils import _pytree as pytree

    from repro_torch.dist.sharding import Mesh, param_pspecs, state_pspecs, use_mesh
    from repro_torch.dist.train import (distribute_batch, distribute_tree, full_tree,
                                        make_sharded_train_step, mesh_ctx_for)
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainStepConfig, value_and_grad

    out = {}
    mesh = Mesh(payload["mesh"], ("data", "model"))
    dm = mesh.to_device_mesh("cpu")
    for arch, np_params in payload["params"].items():
        cfg = _smoke_cfg(arch)
        params = transformer.params_from_jax(cfg, np_params, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in payload["batch"][arch].items()}
        gb = batch["tokens"].shape[0]
        dparams = distribute_tree(params, param_pspecs(cfg, params, mesh), mesh, dm)
        dbatch = distribute_batch(batch, mesh, dm)
        fn = lambda p, b: model_api.lm_loss(cfg, p, b)          # noqa: E731
        with use_mesh(mesh_ctx_for(mesh, gb)), implicit_replication():
            (loss, parts), grads = value_and_grad(fn, has_aux=True,
                                                  unread=transformer.unread_params(cfg))(
                dparams, dbatch)
        grads = full_tree(grads)
        state = {"params": params, **adamw_init(params)}
        dstate = distribute_tree(state, state_pspecs(cfg, state, mesh), mesh, dm)
        step = make_sharded_train_step(cfg, TrainStepConfig(remat=True), mesh, dm,
                                       global_batch=gb)
        _, metrics = step(dstate, batch)
        out[arch] = {
            "loss": _float(loss), "aux": _float(parts["aux"]),
            "grads": [(pytree.keystr(k), g.numpy())
                      for k, g in pytree.tree_flatten_with_path(grads)[0]],
            "metrics": {k: float(v) for k, v in metrics.items()},
        }
    return out


def decode(rank: int, world: int, payload: dict) -> dict:
    """One decode step over a cache sequence-sharded over ``model``, from
    the reference's weights and prefilled cache, for each case."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import Mesh, cache_pspecs, param_pspecs, use_mesh
    from repro_torch.dist.train import distribute_batch, distribute_tree, full_tree, mesh_ctx_for
    from repro_torch.models import transformer

    cfg = _smoke_cfg(payload["arch"])
    mesh = Mesh(payload["mesh"], ("data", "model"))
    dm = mesh.to_device_mesh("cpu")
    params = transformer.params_from_jax(cfg, payload["decode_params"], device="cpu")
    dparams = distribute_tree(params, param_pspecs(cfg, params, mesh), mesh, dm)
    out = []
    for case in payload["cases"]:
        cache = transformer.cache_from_jax(cfg, case["cache"], device="cpu")
        B = case["tokens"].shape[0]
        dcache = distribute_tree(cache, cache_pspecs(cfg, cache, mesh, B), mesh, dm)
        tokens = distribute_batch({"t": torch.from_numpy(case["tokens"])}, mesh, dm)["t"]
        with use_mesh(mesh_ctx_for(mesh, B)), implicit_replication():
            logits, new = transformer.decode_step(cfg, dparams, tokens, dcache)
        placed = [str(tuple(new["layers"][0]["k"].placements))]
        new = full_tree(new)
        out.append({"logits": logits.full_tensor().numpy(),
                    "k0": new["layers"][0]["k"].numpy(), "pos0": new["layers"][0]["pos"].numpy(),
                    "len": new["len"].numpy(), "placements": placed})
    return out


def restore(rank: int, world: int, payload: dict) -> dict:
    """The checkpoint written by one process, restored onto this rank's
    share of a ``payload["mesh"]`` mesh (``restore_state(...,
    placements=)``), gathered back whole."""
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import load_checkpoint, restore_state
    from repro_torch.dist.sharding import Mesh, placements, state_pspecs, tree_map_with_path
    from repro_torch.dist.train import full_tree, spec_at
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import param_specs

    cfg = _smoke_cfg(payload["arch"])
    mesh = Mesh(payload["mesh"], ("data", "model"))
    dm = mesh.to_device_mesh("cpu")
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = param_specs(cfg, device="cpu", fake_mode=mode)
    with mode:
        template = {"params": params, **adamw_init(params)}
    specs = state_pspecs(cfg, template, mesh)
    pls = tree_map_with_path(lambda p, _t: placements(spec_at(specs, p), mesh), template)
    _, flat = load_checkpoint(payload["dir"])
    state = restore_state(template, flat, placements=pls, device_mesh=dm)
    shards = [str(tuple(t.placements)) for t in pytree.tree_leaves(state)]
    whole = full_tree(state)
    return {"leaves": [(pytree.keystr(k), v.numpy())
                       for k, v in pytree.tree_flatten_with_path(whole)[0]],
            "placements": shards}


def adamw_shards(rank: int, world: int, payload: dict) -> dict:
    """``kernels/adamw/ops.py``'s view of a DTensor tree on a 2x2 mesh
    (``prepare``): each leaf's local shards, which leaves this rank counts
    in the global norm, the norm tables' gradients, and the norm's sum of
    squares added over the mesh's groups as ``global_norm_cuda`` adds its
    partial sums."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.dist.sharding import Mesh
    from repro_torch.kernels.adamw import ops

    dm = Mesh((2, 2), ("data", "model")).to_device_mesh("cpu")
    placed = {"rep": [Replicate(), Replicate()], "model": [Replicate(), Shard(0)],
              "both": [Shard(0), Shard(1)], "data_uneven": [Shard(0), Replicate()]}
    p, g, m, v = [], [], [], []
    for name, pl in placed.items():
        full = torch.from_numpy(payload["g"][name])
        p.append(distribute_tensor(full.to(torch.bfloat16), dm, pl))
        m.append(distribute_tensor(torch.zeros_like(full), dm, pl))
        v.append(distribute_tensor(torch.zeros_like(full), dm, pl))
        if name == "both":
            # a Partial gradient: each rank holds a quarter (exact in f32)
            g.append(DTensor.from_local(full / 4, dm, [Partial(), Partial()]))
        else:
            g.append(distribute_tensor(full, dm, pl))
    decay = [True] * len(p)
    prep = ops.prepare(p, g, m, v, decay)
    (lp, lg, lm, lv), counted, groups = ops._shards(p, g, m, v, DTensor)
    total = torch.zeros(1, dtype=torch.float64)
    for x, c in zip(lg, counted):
        if c:
            total += x.double().square().sum()
    for group in groups:
        dist.all_reduce(total, group=group)
    norm_g = [int(r[1]) for t in prep.norm[0] for r in t]
    update_g = [int(r[1]) for t in prep.tables for r in t]
    return {"coord": dm.get_coordinate(), "counted": counted,
            "group_sizes": [dist.get_world_size(grp) for grp in groups],
            "same_storage": [a.data_ptr() == b.to_local().data_ptr()
                             for a, b in zip(lp + lm + lv, p + m + v)],
            "local_shapes": [tuple(x.shape) for x in lg],
            "g_is_shard": [torch.equal(x, y.redistribute(dm, a.placements).to_local())
                           for x, y, a in zip(lg, g, p)],
            "norm_gradients": norm_g == [x for x, c in zip(update_g, counted) if c],
            "table_rows": sum(len(t) for t in prep.tables), "sumsq": float(total)}
