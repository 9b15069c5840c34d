"""The port's training path against the JAX package's, on the smoke gemma-2b
config in f32 with the same weights (``params_from_jax``) and the same
numpy batch: the LM loss and every gradient (through B3's backward on the
CPU path), a train step's loss, gradient norm and AdamW moments; remat and
microbatching, which must not change the gradient; what stays refused of
malformed frontend configs; and the loss + gradient
graph that ``compile_lm_loss(grad=True)`` captures, run on the CPU runtime.

Tolerances: 2e-5 in f32 (the two frameworks sum in other orders).  Params
after a step are not compared: AdamW's first step is about ``lr *
sign(g)``, and a gradient within rounding of zero may take either sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import api as japi
from repro.models import transformer as jt
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import (TrainStepConfig, compile_lm_loss, init_train_state,
                                    lm_loss_fn, make_train_step, param_specs, value_and_grad)

TOL = 2e-5
B, S = 4, 16


def _setup(seed=0):
    jcfg = j_get_config("gemma-2b", smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(seed))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                        # some ignored positions
    np_batch = {"tokens": toks[:, :S].copy(), "labels": labels}
    return jcfg, tcfg, jp, tp, np_batch


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def _by_path(jtree, ttree):
    """(name, port leaf, reference leaf) for every leaf; the reference's
    stacked [L, ...] layers against the port's per-layer list."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers":
            for i in range(np.asarray(leaf).shape[0]):
                t = ttree["layers"][i]
                for kk in keys[1:]:
                    t = t[kk]
                out.append((f"layers/{i}/{keys[1:]}", t, np.asarray(leaf)[i]))
        else:
            t = ttree
            for kk in keys:
                t = t[kk]
            out.append((str(keys), t, np.asarray(leaf)))
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_reference(remat):
    jcfg, tcfg, jp, tp, np_batch = _setup()
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: japi.lm_loss(jcfg, p, jb, remat=remat), has_aux=True)(jp)
    (tl, tparts), tg = value_and_grad(
        lambda p, b: tapi.lm_loss(tcfg, p, b, remat=remat),
        has_aux=True)(tp, _torch_batch(np_batch))
    np.testing.assert_allclose(tl.item(), float(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tparts["ce"].item(), float(jparts["ce"]), atol=TOL, rtol=TOL)
    assert tparts["aux"].item() == float(jparts["aux"]) == 0.0
    pairs = _by_path(jg, tg)
    assert len(pairs) == len(pytree.tree_leaves(tg))
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)


def test_remat_on_and_off_give_the_same_gradients():
    """Remat recomputes each layer's forward in the backward pass: the same
    ops on the same inputs, so the same bits."""
    _, tcfg, _, tp, np_batch = _setup(1)
    batch = _torch_batch(np_batch)
    off = value_and_grad(lm_loss_fn(tcfg, remat=False))(tp, batch)
    on = value_and_grad(lm_loss_fn(tcfg, remat=True))(tp, batch)
    for a, b in zip(pytree.tree_leaves(off), pytree.tree_leaves(on)):
        assert torch.equal(a, b)


def _one_step(tcfg, tp, batch, **kw):
    params = pytree.tree_map(torch.clone, tp)
    state = {"params": params, **adamw_init(params)}
    step = make_train_step(tcfg, TrainStepConfig(adamw=AdamWConfig(lr=1e-3), warmup_steps=1,
                                                 total_steps=10, **kw))
    return step(state, batch)


def test_two_microbatches_equal_one():
    """Accumulating two half-batch gradients (each the mean over its own
    rows) and halving them: the same loss and, after one step, the same
    first moments m = (1 - b1) * clipped gradient, up to f32 rounding (the
    two halves here hold the same number of counted positions)."""
    _, tcfg, _, tp, np_batch = _setup(2)
    np_batch["labels"][1, -3:] = np_batch["tokens"][1, -3:]     # no ignored positions
    batch = _torch_batch(np_batch)
    s1, m1 = _one_step(tcfg, tp, batch, microbatches=1, remat=False)
    s2, m2 = _one_step(tcfg, tp, batch, microbatches=2, remat=True)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), atol=TOL, rtol=TOL)
    for a, b in zip(pytree.tree_leaves(s1["m"]), pytree.tree_leaves(s2["m"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="not divisible"):
        _one_step(tcfg, tp, _torch_batch({k: v[:3] for k, v in np_batch.items()}),
                  microbatches=2)


def test_train_step_matches_reference():
    """One step of the port's ``make_train_step`` and of the reference's
    on the same weights and batch: loss, gradient norm, learning rate, clip
    scale and both moments."""
    jcfg, tcfg, jp, tp, np_batch = _setup(3)
    jtc = jstep.TrainStepConfig(remat=False, warmup_steps=2, total_steps=10)
    jstate = {"params": jp, **jstep.adamw_init(jp, jtc.adamw)}
    jstate, jm = jax.jit(jstep.make_train_step(jcfg, jtc))(
        jstate, {k: jnp.asarray(v) for k, v in np_batch.items()})
    state = {"params": tp, **adamw_init(tp)}
    state, tm = make_train_step(tcfg, TrainStepConfig(remat=False, warmup_steps=2,
                                                      total_steps=10))(state, np_batch)
    for k in ("loss", "ce", "grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for tree in ("m", "v"):
        for name, got, want in _by_path(jstate[tree], state[tree]):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("kw", [{"frontend": "vision"}, {"frontend": "audio"},
                                {"n_encoder_layers": 2, "cross_attention": True}])
def test_frontend_archs_are_refused(kw):
    """The name is kept from when every frontend arch was refused; the
    frontends train now (``tests/test_torch_frontend_train.py``).  A
    vision frontend on a dense decoder is admitted: a train state builds
    and a text-only batch trains.  What stays refused is a malformed
    frontend, by ``_check_arch``: audio without an encoder and
    cross-attention, or an encoder without the audio frontend."""
    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32, **kw)
    if kw == {"frontend": "vision"}:
        tt.check_trainable(cfg)
        state = init_train_state(cfg, 0, device="cpu")
        batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32),
                 "labels": torch.ones((2, 4), dtype=torch.int32)}
        state, metrics = make_train_step(cfg, TrainStepConfig(remat=False))(state, batch)
        assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
        return
    with pytest.raises(ValueError, match="and the audio .encoder . cross-attention. and vision "
                                         "frontends"):
        tt.forward(cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_loss_plus_gradient_graph_runs_like_eager():
    """``compile_lm_loss(grad=True)``: the forward and its backward (B3's
    training and backward ops, one attention node each per layer) in one
    graph, larger than the forward graph; the CPU runtime's static plan,
    dynamic scheduler and ``Graph.execute`` give eager autograd's loss and
    gradients bit for bit."""
    from repro_torch.runtime import Runtime

    _, tcfg, _, _, np_batch = _setup(4)
    tp = tt.init_params(tcfg, 4, device="cpu")      # the structure the specs have
    shape = ShapeSpec("t", S, B, "train")
    with Runtime(2, device="cpu") as rt:
        fwd = compile_lm_loss(tcfg, shape, backend="sim", runtime=rt, device="cpu")
        exe = compile_lm_loss(tcfg, shape, backend="host", grad=True, runtime=rt, device="cpu")
        assert len(exe.graph) > len(fwd.graph)
        kinds = [n.kind for n in exe.graph.nodes]
        assert kinds.count("attention") == 2 * tcfg.n_layers
        assert [n.kind for n in fwd.graph.nodes].count("attention") == tcfg.n_layers
        batch = _torch_batch(np_batch)
        want = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg))(tp, batch))
        inputs = exe.captured.bind((tp, batch))
        runs = [exe.captured.unflatten(exe.execute_host(inputs, host_mode=m).outputs)
                for m in ("static", "dynamic")]
        runs.append(exe.captured.unflatten(exe.graph.execute(inputs)))
    for run in runs:
        got = pytree.tree_leaves(run)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_specs_batches_and_flops_match_reference():
    jcfg, tcfg = j_get_config("gemma-2b"), get_config("gemma-2b")
    jshape, tshape = JShapeSpec("t", 512, 4, "train"), ShapeSpec("t", 512, 4, "train")
    specs = tapi.input_specs(tcfg, tshape, device="cpu")
    jspecs = japi.input_specs(jcfg, jshape)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in specs.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
    for fn in ("model_train_flops", "model_decode_flops", "model_prefill_flops"):
        assert getattr(tapi, fn)(tcfg, tshape) == getattr(japi, fn)(jcfg, jshape)
    assert tapi.token_counts(tcfg, tshape) == japi.token_counts(jcfg, jshape)
    batch = tapi.make_batch(tcfg, tshape, torch.Generator().manual_seed(0))
    assert batch["tokens"].shape == (4, 512) and batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    assert (batch["labels"][:, -1] == tapi.IGNORE).all()
    # the parameter specs: the reference's shapes (its stacked layers split)
    p = param_specs(tcfg, device="cpu")
    jp = jax.eval_shape(lambda k: jt.init_params(jcfg, k), jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        ts = [p["layers"][i] for i in range(tcfg.n_layers)] if keys[0] == "layers" else [p]
        for t in ts:
            for kk in keys[1:] if keys[0] == "layers" else keys:
                t = t[kk]
            want = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
            assert tuple(t.shape) == tuple(want) and t.dtype == torch.bfloat16, keys
