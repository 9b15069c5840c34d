"""The port's optimizer against the JAX package's, on the same numpy arrays:
the learning-rate schedules, the global norm, and AdamW's update (clip,
moments, bias correction, the decay mask) with f32 and bf16 parameters.

Tolerances: f32 results within 2e-6 relative (the two frameworks' f32
``pow`` / ``sqrt`` / sums may round their last bit differently); a bf16
parameter may then round to the neighbouring bf16 value, so bf16 params
compare within one bf16 ulp (at most 2^-7 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                               global_norm, linear_warmup_cosine)

J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 500, 1000, 2000])
def test_schedules_match_reference(step):
    s = np.int32(step)
    want = jschedule.linear_warmup_cosine(jnp.asarray(s), 3e-3, 100, 1000)
    got = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-3, 100, 1000)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    want = jschedule.cosine_schedule(jnp.asarray(s), 1e-3, 700, min_frac=0.2)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), 1e-3, 700, min_frac=0.2)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)


def _tree(rng, dtype):
    """A param-dict shaped like a model's: decayed matrices, and leaves the
    mask spares (norm gains, a bias named ``b``, ``final_norm``)."""
    def a(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return {"embed": a(16, 8), "final_norm": a(8),
            "layers": [{"ln1": a(8), "attn": {"wq": a(8, 8), "wo": a(8, 8)},
                        "mlp": {"w_up": a(8, 12), "b": a(12)}} for _ in range(2)]}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(J_DT[dtype]), tree)


def _to_torch(tree, dtype):
    return torch.utils._pytree.tree_map(lambda x: torch.from_numpy(x.copy()).to(T_DT[dtype]),
                                        tree, is_leaf=lambda x: isinstance(x, np.ndarray))


def _compare(got, want, dtype):
    # the port keeps dict insertion order, JAX sorts keys: compare by path
    gp = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(torch.utils._pytree.tree_map(
              lambda t: t.detach().float().numpy(), got))[0]}
    wp = {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    assert gp.keys() == wp.keys()
    rtol = 2 ** -7 if dtype == "bfloat16" else 2e-6
    for k in gp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=rtol, atol=1e-7, err_msg=k)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng, "float32")
    want = jadamw.global_norm(_to_jax(tree, "float32"))
    got = global_norm(_to_torch(tree, "float32"))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_matches_reference(dtype, clip, weight_decay):
    """Three updates from the same params and grads (the second and third
    from carried moments), through both packages; the clip either bites
    (1.0) or not (1e3)."""
    rng = np.random.default_rng(1)
    params = _tree(rng, dtype)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=weight_decay, clip_norm=clip)
    tcfg = AdamWConfig(lr=1e-2, weight_decay=weight_decay, clip_norm=clip)
    jp, tp = _to_jax(params, dtype), _to_torch(params, dtype)
    jst, tst = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for it in range(3):
        grads = _tree(rng, dtype)
        lr = 1e-2 * (it + 1) / 3
        jp, jst, jm = jadamw.adamw_update(_to_jax(grads, dtype), jp, jst, jcfg, lr=lr)
        tp, tst, tm = adamw_update(_to_torch(grads, dtype), tp, tst, tcfg,
                                   lr=torch.tensor(lr))
        assert int(tst["step"]) == int(jst["step"]) == it + 1
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-6)
        np.testing.assert_allclose(tm["clip_scale"].item(), float(jm["clip_scale"]), rtol=2e-6)
        _compare(tst["m"], jst["m"], "float32")
        _compare(tst["v"], jst["v"], "float32")
        _compare(tp, jp, dtype)
    assert all(t.dtype == T_DT[dtype] for t in torch.utils._pytree.tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in torch.utils._pytree.tree_leaves(tst["m"]))


def test_decay_mask_spares_norms_and_biases():
    """With zero gradients only decoupled decay moves a parameter: the
    matrices shrink by lr * wd * p, the norm gains and biases do not."""
    rng = np.random.default_rng(2)
    tp = _to_torch(_tree(rng, "float32"), "float32")
    before = torch.utils._pytree.tree_map(torch.clone, tp)
    zeros = torch.utils._pytree.tree_map(torch.zeros_like, tp)
    adamw_update(zeros, tp, adamw_init(tp), AdamWConfig(lr=0.5, weight_decay=0.1))
    for name in ("final_norm",):
        assert torch.equal(tp[name], before[name])
    assert torch.allclose(tp["embed"], before["embed"] * (1 - 0.05))
    for lp, lb in zip(tp["layers"], before["layers"]):
        assert torch.equal(lp["ln1"], lb["ln1"]) and torch.equal(lp["mlp"]["b"], lb["mlp"]["b"])
        assert torch.allclose(lp["attn"]["wq"], lb["attn"]["wq"] * (1 - 0.05))


def test_adamw_updates_in_place():
    rng = np.random.default_rng(3)
    tp = _to_torch(_tree(rng, "float32"), "float32")
    st = adamw_init(tp)
    ids = [id(t) for t in torch.utils._pytree.tree_leaves((tp, st["m"], st["v"]))]
    new_p, new_st, _ = adamw_update(_to_torch(_tree(rng, "float32"), "float32"), tp, st)
    assert [id(t) for t in torch.utils._pytree.tree_leaves(
        (new_p, new_st["m"], new_st["v"]))] == ids
    assert int(new_st["step"]) == 1 and int(st["step"]) == 0


# ---------------------------------------------------------------------------
# the multi-tensor kernels' host side (kernels/adamw/ops.py) and the dispatch
# ---------------------------------------------------------------------------

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.kernels.adamw import ops as fused  # noqa: E402
from repro_torch.optim.adamw import _decayable  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402

C = fused.CHUNK


@pytest.mark.parametrize("numels, max_leaves", [
    ([1], fused.MAX_LEAVES),
    ([1, 3, C - 1, C, C + 1, 3 * C + 5, 0, 7], fused.MAX_LEAVES),
    ([5, 2 * C, 1, C + 9, 11, 0, 4 * C - 3], 3),
    ([C] * 5 + [1], 1),
])
def test_plan_covers_every_element_of_every_leaf_once(monkeypatch, numels, max_leaves):
    """Every chunk lies inside its leaf, the chunks of a leaf tile it with
    no gap and no overlap (the last ragged), each launch holds at most
    ``MAX_LEAVES`` leaves, and the launches take the leaves in order."""
    monkeypatch.setattr(fused, "MAX_LEAVES", max_leaves)
    pl = fused.plan(numels)
    covered = {j: [] for j in range(len(numels))}
    next_lo = next_row = 0
    for lo, hi, first, count in pl.splits:
        assert lo == next_lo and 0 < hi - lo <= max_leaves and first == next_row
        for leaf, c in pl.chunks[first:first + count]:
            assert 0 <= leaf < hi - lo
            j = lo + int(leaf)
            start = int(c) * C
            assert start < numels[j]
            covered[j].append((start, min(start + C, numels[j])))
        next_lo, next_row = hi, first + count
    assert next_lo == len(numels) and next_row == len(pl.chunks)
    assert pl.chunks.dtype == np.int32 and pl.chunks.shape[1] == 2
    for j, n in enumerate(numels):
        pos = 0
        for a, b in sorted(covered[j]):
            assert a == pos and b > a
            pos = b
        assert pos == n


def _fused_calls(monkeypatch):
    """Send ``adamw_update`` down the fused path on CPU tensors, with the
    kernels replaced by recorders of what they were handed."""
    seen = {}

    def plan_on(numels, device):
        pl = fused.plan(numels)
        return torch.from_numpy(pl.chunks), pl.splits

    def norm(tables, chunks, splits, clip, groups=()):
        seen["norm"] = (tables, chunks, splits, clip)
        seen["groups"] = groups
        return torch.tensor(1.0), torch.tensor(1.0)

    def update(tables, chunks, splits, scale, lr, b1c, b2c, **kw):
        seen["update"] = (tables, chunks, splits, kw)

    monkeypatch.setattr(fused, "refusal", lambda *a: None)
    monkeypatch.setattr(fused, "device_plan", plan_on)
    monkeypatch.setattr(fused, "global_norm_cuda", norm)
    monkeypatch.setattr(fused, "adamw_update_cuda", update)
    return seen


def test_leaf_table_holds_pointers_sizes_dtypes_of_each_leaf(monkeypatch):
    """A 1-element leaf, odd sizes, a view at an odd offset and mixed bf16
    and f32 leaves: each row holds the leaf's own pointers (the view's, at
    its offset), its numel and its dtype pair; the tables split as the
    plan does."""
    buf = torch.zeros(1001, dtype=torch.bfloat16)
    ps = [buf[3:3 + 997].view(997), torch.zeros(1, dtype=torch.float32),
          torch.zeros(2 * C + 3, dtype=torch.bfloat16), torch.zeros(5, dtype=torch.float16)]
    gs = [torch.zeros(997, dtype=torch.bfloat16), torch.zeros(1, dtype=torch.float32),
          torch.zeros(2 * C + 3, dtype=torch.float32), torch.zeros(5, dtype=torch.float16)]
    ms = [torch.zeros(p.shape) for p in ps]
    vs = [torch.zeros(p.shape) for p in ps]
    decay = [True, False, True, False]
    monkeypatch.setattr(fused, "MAX_LEAVES", 3)
    splits = fused.plan([p.numel() for p in ps]).splits
    tables = fused.leaf_tables(ps, gs, ms, vs, decay, splits)
    assert [len(t) for t in tables] == [3, 1]
    table = np.concatenate(tables)
    assert table.dtype == np.int64 and table.shape == (4, 6)
    assert ps[0].data_ptr() == buf.data_ptr() + 3 * 2
    for row, p, g, m, v, d in zip(table, ps, gs, ms, vs, decay):
        assert list(row[:5]) == [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                                 p.numel()]
        assert row[5] & 0xFFFFFFFF == fused._CODES[p.dtype] * 3 + fused._CODES[g.dtype]
        assert row[5] >> 32 == int(d)
    assert [int(r[5] & 0xFFFFFFFF) for r in table] == [4, 0, 3, 8]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b", "h2o-danube3-4b"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_fused_path_decays_the_leaves_the_loop_decays(monkeypatch, arch, weight_decay):
    """The tables ``adamw_update`` hands the kernels: each leaf's decay flag
    is ``_decayable`` of its path (none where the decay is 0), its row
    holds the parameter's, gradient's and moments' pointers, and the
    norm and the update get the same tables and the config's scalars."""
    seen = _fused_calls(monkeypatch)
    params = init_train_state(get_config(arch, smoke=True), 0, device="cpu")["params"]
    grads = pytree.tree_map(torch.zeros_like, params)
    st = adamw_init(params)
    cfg = AdamWConfig(weight_decay=weight_decay, clip_norm=0.5)
    adamw_update(grads, params, st, cfg)
    tables, _, splits, clip = seen["norm"]
    assert seen["update"][0] is tables and clip == 0.5
    assert seen["update"][3] == {"b1": cfg.b1, "b2": cfg.b2, "eps": cfg.eps,
                                 "weight_decay": weight_decay}
    table = np.concatenate(tables)
    flat = pytree.tree_flatten_with_path(params)[0]
    want = [bool(weight_decay) and _decayable(path) for path, _ in flat]
    assert [bool(r[5] >> 32) for r in table] == want
    assert any(want) == bool(weight_decay) and not all(want)
    leaves = zip(*(pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])))
    assert [list(r[:4]) for r in table] == [[t.data_ptr() for t in ts] for ts in leaves]


def _small_state(dtype=torch.bfloat16):
    rng = np.random.default_rng(4)
    tree = _tree(rng, "float32")
    params = _to_torch(tree, "bfloat16" if dtype == torch.bfloat16 else "float32")
    grads = pytree.tree_map(lambda p: torch.ones_like(p) * 0.25, params)
    return params, grads, adamw_init(params)


def _counted(fn):
    trace.reset()
    trace.enable()
    try:
        with trace.span("step", root=True):
            fn()
        return {k: sum(v.values()) for k, v in trace.snapshot()["counters"].items()}
    finally:
        trace.disable()
        trace.reset()


def test_dispatch_takes_the_loop_for_cpu_tensors_and_counts_it():
    params, grads, st = _small_state()
    n = len(pytree.tree_leaves(params))
    leaves = [pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])]
    assert fused.refusal(*leaves) == "the first leaf is on cpu"
    counts = _counted(lambda: adamw_update(grads, params, st))
    assert counts == {"optim.fused_leaves": 0, "optim.plain_leaves": n}


def test_dispatch_refuses_a_non_contiguous_gradient():
    """A non-contiguous gradient: on the CPU the loop takes it as it is;
    the kernels are handed a contiguous copy of it (and an f64 gradient as
    f32, as the loop's ``g.float()`` rounds it), the other gradients as
    they are."""
    params, grads, st = _small_state()
    grads["embed"] = grads["embed"].t().contiguous().t()
    grads["final_norm"] = grads["final_norm"].double()
    leaves = [pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])]
    assert fused.refusal(*leaves) == "the first leaf is on cpu"
    before = params["embed"].clone()
    counts = _counted(lambda: adamw_update(grads, params, st))
    assert counts["optim.plain_leaves"] == len(leaves[0])
    assert not torch.equal(params["embed"], before)
    handed = fused._checked(*leaves)
    for g, h in zip(leaves[1], handed):
        if g is grads["embed"] or g is grads["final_norm"]:
            assert h is not g and h.is_contiguous() and torch.equal(h, g.float())
            assert h.dtype == (torch.float32 if g.dtype == torch.float64 else g.dtype)
        else:
            assert h is g


def _transpose_first_matrix(leaves):
    i = next(i for i, t in enumerate(leaves) if t.dim() == 2)
    leaves[i] = leaves[i].t().contiguous().t()


@pytest.mark.parametrize("refused, why", [
    (lambda ls: ls[0].__setitem__(0, ls[0][0].double()), "has dtypes"),
    (lambda ls: ls[2].__setitem__(0, ls[2][0].to(torch.bfloat16)), "has dtypes"),
    (lambda ls: ls[1].__setitem__(0, ls[1][0][:1]), "has shapes"),
    (lambda ls: _transpose_first_matrix(ls[3]), "not contiguous"),
    (lambda ls: [x.clear() for x in ls], "no leaves"),
])
def test_refusal_names_dtypes_shapes_and_an_empty_tree(monkeypatch, refused, why):
    """The loop takes an empty tree (``refusal``); a tree on the card whose
    dtypes, shapes or a moment's layout the kernels cannot take raises,
    naming the leaf, and never falls back to the loop."""
    params, grads, st = _small_state()
    leaves = [pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])]
    refused(leaves)
    if why == "no leaves":
        assert fused.refusal(*leaves) == why
        return
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    assert fused.refusal(*leaves) is None
    with pytest.raises(ValueError, match=why):
        fused.prepare(*leaves, [False] * len(leaves[0]))
    monkeypatch.undo()
    monkeypatch.setattr(fused, "refusal", lambda *a: None)
    with pytest.raises(ValueError, match=why):
        adamw_update(*(pytree.tree_unflatten(ls, pytree.tree_structure(params))
                       for ls in leaves[1::-1]),
                     {"m": pytree.tree_unflatten(leaves[2], pytree.tree_structure(params)),
                      "v": pytree.tree_unflatten(leaves[3], pytree.tree_structure(params)),
                      "step": st["step"]})


def test_dispatch_takes_the_loop_for_fake_tensors(monkeypatch):
    """Under ``FakeTensorMode`` the loop runs on the fake tensors and no
    kernel is called: ``refusal`` names the fake tensor, on a fake CUDA
    device as on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_kernel(*a, **k):
        raise AssertionError("a kernel was called under FakeTensorMode")

    monkeypatch.setattr(fused, "global_norm_cuda", no_kernel)
    monkeypatch.setattr(fused, "adamw_update_cuda", no_kernel)
    with FakeTensorMode():
        for device in ("cuda", "cpu"):
            params = {"w": torch.zeros(4, 3, dtype=torch.bfloat16, device=device),
                      "ln": torch.ones(3, dtype=torch.bfloat16, device=device)}
            grads = pytree.tree_map(torch.ones_like, params)
            st = adamw_init(params)
            leaves = [pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])]
            assert fused.refusal(*leaves) == "a parameter is a FakeTensor"
        new_p, new_st, metrics = adamw_update(grads, params, st, AdamWConfig(lr=0.1))
        assert new_p["w"].shape == (4, 3) and metrics["grad_norm"].shape == ()


def test_refusal_sees_a_capture(monkeypatch):
    """Leaves that pass every other check (CPU tensors made to read as on
    the card) are refused while a capture is in progress."""
    params, grads, st = _small_state()
    leaves = [pytree.tree_leaves(t) for t in (params, grads, st["m"], st["v"])]
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    assert fused.refusal(*leaves) is None
    monkeypatch.setattr(trace, "capturing", lambda: True)
    assert fused.refusal(*leaves) == "a capture is in progress"


def test_fused_dispatch_counts_its_leaves(monkeypatch):
    _fused_calls(monkeypatch)
    params, grads, st = _small_state()
    n = len(pytree.tree_leaves(params))
    counts = _counted(lambda: adamw_update(grads, params, st))
    assert counts == {"optim.fused_leaves": n, "optim.plain_leaves": 0}


def test_sharded_tree_takes_the_kernels_through_its_local_shards():
    """A DTensor tree on a 2x2 mesh of four gloo ranks (a leaf replicated,
    one sharded over the model axis, one over both with a Partial
    gradient, one over the data axis unevenly): ``prepare`` hands the
    kernels each leaf's local shards (the parameter's and moments' own
    storage, the gradient redistributed to its parameter's placements),
    counts a leaf in the norm on the ranks at coordinate 0 of each
    dimension it is replicated over, and the partial sums added over the
    mesh's groups give the whole tree's sum of squares on every rank."""
    import torch_dist_workers as workers

    rng = np.random.default_rng(7)
    g = {"rep": rng.integers(-8, 8, (3, 5)), "model": rng.integers(-8, 8, (4, 6)),
         "both": rng.integers(-8, 8, (4, 6)) * 4, "data_uneven": rng.integers(-8, 8, (3, 2))}
    g = {k: x.astype(np.float32) for k, x in g.items()}
    want = float(sum(np.square(x.astype(np.float64)).sum() for x in g.values()))
    res = workers.launch(4, ["adamw_shards"], {"g": g}, timeout=180)
    for r in (x["adamw_shards"] for x in res):
        d, m = r["coord"]
        assert r["counted"] == [d == 0 and m == 0, d == 0, True, m == 0]
        assert r["group_sizes"] == [2, 2] and all(r["same_storage"]) and all(r["g_is_shard"])
        assert r["norm_gradients"] and r["table_rows"] == 4
        assert r["local_shapes"] == [(3, 5), (2, 6), (2, 3), ((2, 2), (1, 2))[d]]
        assert r["sumsq"] == want
