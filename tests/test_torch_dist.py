"""The port's sharding layer against the JAX package's ``repro.dist``.

* the spec factories (``param_pspecs`` / ``state_pspecs`` with ``fsdp``
  off and on, ``batch_pspecs``, ``cache_pspecs``) equal the reference's
  for every zoo config at full width on the meshes (4, 2), (16, 16),
  (2, 16, 16), (32, 8) and (2, 32, 8).  Shapes come from the port's
  fake-tensor init against the reference's ``jax.eval_shape``; both sides
  take the port's ``Mesh`` (the factories read axis names and extents
  only), and the reference's stacked layers are read per layer;
* the ``shard()`` contract on DTensors of a ``fake`` process group: a
  no-op without a mesh or on a plain tensor, placements from the resolved
  spec, indivisible and already-consumed axes dropped;
* ``batch_axes`` against the reference's;
* ``plan_from_schedule``'s slots, placement and sub-meshes against the
  reference's on the same graph, the reference on the conftest's 8 host
  devices;
* the ``"mesh"`` backend's outputs equal to the ``"host"`` backend's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import list_archs as j_list_archs
from repro.dist import sharding as jsh
from repro.models import api as japi
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, list_archs
from repro_torch.dist import sharding as tsh
from repro_torch.dist.sharding import Mesh

ARCHS = [a.replace("_", "-") for a in list_archs()]
# the archs the JAX package has too (the port's latent-attention arch is its own)
REF_ARCHS = [a for a in ARCHS if a.replace("-", "_") in j_list_archs()]
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}


def _unstack(tree):
    """The reference's stacked ``[L, ...]`` layer dicts as a per-layer list
    of shape structs (the port's layout)."""
    if isinstance(tree, list):
        return tree
    n = jax.tree.leaves(tree)[0].shape[0]
    return [jax.tree.map(lambda s, i=i: jax.ShapeDtypeStruct(s.shape[1:], s.dtype), tree)
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(port params, reference params in the port's layout) as shapes."""
    from repro_torch.train.step import param_specs

    jcfg = j_get_config(arch)
    jp = jax.eval_shape(lambda k: jt.init_params(jcfg, k), jax.random.key(0))
    jp = dict(jp)
    for key in ("layers", "enc_layers"):
        if key in jp:
            jp[key] = _unstack(jp[key])
    tp = param_specs(get_config(arch), device="cpu")
    return tp, jp


def _leaves(tree, is_leaf=None):
    return {pytree.keystr(k): v for k, v in pytree.tree_flatten_with_path(tree)[0]}


def _jleaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out["".join(f"[{k!r}]" for k in keys)] = leaf
    return out


def _specs_equal(port_specs, ref_specs):
    got = {k: tuple(v) for k, v in _port_spec_leaves(port_specs).items()}
    want = {k: tuple(v) for k, v in _jleaves(ref_specs).items()}
    assert got == want


def _port_spec_leaves(specs, path=""):
    """{keystr: spec} of a port spec tree (its leaves are tuples)."""
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_spec_leaves(v, f"{path}[{k!r}]"))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_spec_leaves(v, f"{path}[{i}]"))
        return out
    return {path: specs}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_spec_factories_match_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = Mesh(shape, names)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tp, jp = _trees(arch)
    # the same leaves with the same shapes
    tl = {k: tuple(v.shape) for k, v in _leaves(tp).items()}
    jl = {k: tuple(v.shape) for k, v in _jleaves(jp).items()}
    assert tl == jl
    for fsdp in (False, True):
        _specs_equal(tsh.param_pspecs(cfg, tp, mesh, fsdp=fsdp),
                     jsh.param_pspecs(jcfg, jp, mesh, fsdp=fsdp))
        tstate = {"params": tp, "m": tp, "v": tp, "step": torch.zeros((), dtype=torch.int32)}
        jstate = {"params": jp, "m": jp, "v": jp,
                  "step": jax.ShapeDtypeStruct((), jnp.int32)}
        _specs_equal(tsh.state_pspecs(cfg, tstate, mesh, fsdp=fsdp),
                     jsh.state_pspecs(jcfg, jstate, mesh, fsdp=fsdp))
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import api as tapi
    from repro_torch.models import transformer as tt

    for sname in ("train_4k", "prefill_32k", "decode_32k"):
        tb = tapi.input_specs(cfg, SHAPES[sname], device="cpu")
        jb = japi.input_specs(jcfg, J_SHAPES[sname])
        gb = SHAPES[sname].global_batch
        _specs_equal(tsh.batch_pspecs(tb, mesh, gb), jsh.batch_pspecs(jb, mesh, gb))
    for sname in ("prefill_32k", "decode_32k"):
        B, S = SHAPES[sname].global_batch, SHAPES[sname].seq_len
        with FakeTensorMode():
            tc = tt.init_cache(cfg, B, S, device="cpu")
        jc = jax.eval_shape(lambda: jt.init_cache(jcfg, B, S))
        tspec = tsh.cache_pspecs(cfg, tc, mesh, B)
        jspec = jsh.cache_pspecs(jcfg, jc, mesh, B)
        want = {}
        for k, v in _jleaves(jspec).items():
            if k.startswith("['layers']['"):          # stacked: [L, ...] per layer
                name = k[len("['layers']"):]
                for i in range(cfg.n_layers):
                    want[f"['layers'][{i}]{name}"] = tuple(v)[1:]
            else:
                want[k] = tuple(v)
        got = {k: tuple(v) for k, v in _port_spec_leaves(tspec).items()}
        assert got == want, sname


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(REF_ARCHS)))
def test_spec_factories_cover_an_arch_the_reference_lacks(arch, mesh_name):
    """An arch with no JAX counterpart (moonlight-16b-a3b: latent attention,
    shared experts, a sigmoid router's bias): every leaf of the params and
    the train state gets a spec of its rank, the batch specs as for any
    arch; it trains only, so its cache raises."""
    shape, names = MESHES[mesh_name]
    mesh = Mesh(shape, names)
    cfg = get_config(arch)
    tp = _trees_port(arch)
    for fsdp in (False, True):
        specs = _port_spec_leaves(tsh.param_pspecs(cfg, tp, mesh, fsdp=fsdp))
        leaves = _leaves(tp)
        assert specs.keys() == leaves.keys()
        for k, v in leaves.items():
            assert len(specs[k]) == len(v.shape), k
        tstate = {"params": tp, "m": tp, "v": tp, "step": torch.zeros((), dtype=torch.int32)}
        assert len(_port_spec_leaves(tsh.state_pspecs(cfg, tstate, mesh, fsdp=fsdp))) == \
            3 * len(leaves) + 1
    from repro_torch.models import api as tapi
    from repro_torch.models import transformer as tt

    tb = tapi.input_specs(cfg, SHAPES["train_4k"], device="cpu")
    assert set(tsh.batch_pspecs(tb, mesh, SHAPES["train_4k"].global_batch)) == {"tokens", "labels"}
    with pytest.raises(ValueError, match="latent attention"):
        tt.init_cache(cfg, 2, 16, device="cpu")


@functools.lru_cache(maxsize=None)
def _trees_port(arch):
    from repro_torch.train.step import param_specs

    return param_specs(get_config(arch), device="cpu")


@pytest.fixture
def fake_group():
    """Rank 0 of a fake 8-rank group (collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_shard_contract(fake_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(8, 6, 4)
    assert tsh.shard(x, "batch", None, "model") is x          # no mesh
    mesh = Mesh((4, 2), ("data", "model"))
    dm = mesh.to_device_mesh("cpu")
    ctx = tsh.MeshCtx(mesh, ("data",))
    with tsh.use_mesh(ctx):
        assert tsh.mesh_context() is ctx
        assert tsh.shard(x, "batch", None, "model") is x      # a plain tensor
        d = distribute_tensor(x, dm, [Replicate(), Replicate()], src_data_rank=None)
        y = tsh.shard(d, "batch", None, "model")
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 6, 2)
        # 6 rows do not split over 4 data ranks: the axis is dropped
        z = tsh.shard(distribute_tensor(torch.randn(6, 4), dm, [Replicate(), Replicate()],
                                        src_data_rank=None), "batch", "model")
        assert tuple(z.placements) == (Replicate(), Shard(1))
        # model consumed by the first dim: the second drops it
        w = tsh.shard(d, "model", "model", None)
        assert tuple(w.placements) == (Replicate(), Shard(0))
        # a fully replicated constraint is no constraint
        assert tsh.shard(d, None, None, None) is d
        with pytest.raises(ValueError):
            tsh.shard(d, "batch")
    assert tsh.mesh_context() is None
    assert tsh.placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert tsh.placements(("model", None, "data"), mesh) == (Shard(2), Shard(0))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_axes_match_reference(mesh_name):
    mesh = Mesh(*MESHES[mesh_name])
    for gb in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512, 96):
        assert tsh.batch_axes(mesh, gb) == jsh.batch_axes(mesh, gb)


def test_plan_from_schedule_matches_reference():
    from jax.sharding import Mesh as JMesh

    from repro.core import cost_model as j_cost
    from repro.core import scheduler as j_sched
    from repro.core.wavefront import recurrence_graph as j_rec
    from repro.dist.executor_mesh import executor_groups as j_groups
    from repro.dist.executor_mesh import plan_from_schedule as j_plan
    from repro_torch.core import cost_model as t_cost
    from repro_torch.core import scheduler as t_sched
    from repro_torch.core.wavefront import recurrence_graph as t_rec
    from repro_torch.dist.executor_mesh import (executor_groups, executor_stacked_mesh,
                                                lane_pspec, plan_from_schedule)

    jg = j_rec(4, 6, flops_per_cell=2e6, bytes_per_cell=1e5)
    tg = t_rec(4, 6, flops_per_cell=2e6, bytes_per_cell=1e5)
    js = j_sched.make_schedule(jg, j_cost.KNL7250, n_executors=2, team_size=2)
    ts = t_sched.make_schedule(tg, t_cost.KNL7250, n_executors=2, team_size=2)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    tmesh = Mesh((4, 2), ("data", "model"))
    jp = j_plan(jg, js, jmesh)
    tp = plan_from_schedule(tg, ts, tmesh)
    assert tp.slots == jp.slots
    assert tp.placement == jp.placement
    assert [g.device_ids for g in tp.groups] == [
        tuple(int(d.id) for d in g.mesh.devices.flat) for g in jp.groups]
    for axis in ("data", "model", None):
        assert [g.device_ids for g in executor_groups(tmesh, 2, axis=axis)] == [
            g.device_ids for g in j_groups(jmesh, 2, axis=axis)]
    sm = executor_stacked_mesh(tmesh, 2, axis="data")
    assert sm.axis_names == ("executor", "data", "model") and tuple(sm.shape.values()) == (2, 2, 2)
    assert lane_pspec(3) == ("executor", None, None)


def _branches(x, w):
    ys = [torch.tanh(x @ (w * (0.1 * (i + 1)))) for i in range(4)]
    return torch.sum(sum(ys) ** 2)


def test_mesh_backend_matches_host_backend():
    import repro_torch
    from repro_torch.core.cost_model import KNL7250
    from repro_torch.core.graph import Graph

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    rt = repro_torch.Runtime(device="cpu")
    try:
        mesh = Mesh((4, 1), ("data", "model"))
        mexe = repro_torch.compile(_branches, x, w, backend="mesh", mesh=mesh, n_executors=4,
                                   team_size=2, runtime=rt, hw=KNL7250)
        hexe = repro_torch.compile(_branches, x, w, backend="host", n_executors=4,
                                   team_size=2, runtime=rt, hw=KNL7250)
        got, want = mexe(x, w), hexe(x, w)
        assert torch.equal(got, want)
        assert abs(float(got - _branches(x, w))) < 1e-4 * abs(float(want))
        assert mexe.last_plan.n_executors == 4
        assert mexe.static_plan() is mexe.last_plan            # cached default plan
        g = Graph("run")
        g.add_op("x", fn=lambda: 2.0)
        g.add_op("y", deps=("x",), flops=1.0, fn=lambda a: a * 3)
        exe = repro_torch.compile(g, backend="mesh", mesh=mesh, n_executors=2, team_size=2,
                                  runtime=rt)
        assert exe()["y"] == 6.0
        with pytest.raises(ValueError):
            repro_torch.compile(g, backend="mesh", n_executors=2, team_size=2,
                                runtime=rt).static_plan()
    finally:
        rt.close()
