"""Training of the MoE, Mamba and Griffin families against the JAX package,
on the CPU at smoke size in f32, with the same weights (``params_from_jax``)
and the same numpy batch: the LM loss, the MoE load-balancing loss and
every gradient of granite-moe-1b-a400m, olmoe-1b-7b, falcon-mamba-7b and
recurrentgemma-2b, with remat on and off (the gradients run through the
plain backwards of B5, B6 and B7 here, their kernels on the card); one
``make_train_step`` step of a MoE and a recurrent config against the
reference's; remat's count of each kernel op (forward twice, backward
once a layer) and its bits; and the loss + gradient graph that
``compile_lm_loss(grad=True)`` captures for each family, run on the CPU
runtime.

Tolerance: 2e-5 (f32; the two frameworks sum in other orders, and the
reference runs its Mamba and RG-LRU scans as chunked associative scans,
``ssm_scan_fused`` and ``linear_recurrence_chunked``).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import transformer as jt
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init
from repro_torch.train.step import (TrainStepConfig, compile_lm_loss, init_train_state,
                                    lm_loss_fn, make_train_step, value_and_grad)

TOL = 2e-5
B, S = 4, 16
ARCHS = ["granite-moe-1b-a400m", "olmoe-1b-7b", "falcon-mamba-7b", "recurrentgemma-2b"]
# each family's kernel op under autograd, its backward op, and the layers
# that run them (falcon-mamba's scan takes its training op, which keeps
# the chunk checkpoints its backward reads)
KERNEL_OPS = {"granite-moe-1b-a400m": ("moe_gmm", "moe_gmm_bwd", "attn", 3),
              "falcon-mamba-7b": ("ssm_scan_train", "ssm_scan_bwd", "ssm", 1),
              "recurrentgemma-2b": ("rglru_scan", "rglru_scan_bwd", "rglru", 1)}


def _setup(arch, seed=0):
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(seed))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                        # some ignored positions
    return jcfg, tcfg, jp, tp, {"tokens": toks[:, :S].copy(), "labels": labels}


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def _by_path(jtree, ttree):
    """(name, port leaf, reference leaf) for every leaf; the reference's
    stacked [L, ...] layers (or its per-layer list for a mixed pattern)
    against the port's per-layer list."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers" and isinstance(jtree["layers"], dict):
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


class _OpCounts(TorchDispatchMode):
    """Calls of each of this package's custom ops (``repro_torch::*``)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_aux_and_grads_match_reference(arch, remat):
    jcfg, tcfg, jp, tp, np_batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: japi.lm_loss(jcfg, p, jb, remat=remat), has_aux=True)(jp)
    (tl, tparts), tg = value_and_grad(
        lambda p, b: tapi.lm_loss(tcfg, p, b, remat=remat),
        has_aux=True)(tp, _torch_batch(np_batch))
    np.testing.assert_allclose(tl.item(), float(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tparts["ce"].item(), float(jparts["ce"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tparts["aux"].item(), float(jparts["aux"]), atol=TOL, rtol=TOL)
    if tcfg.n_experts:
        assert tparts["aux"].item() > 0
        np.testing.assert_allclose(tl.item(), (tparts["ce"] + 0.01 * tparts["aux"]).item(),
                                   atol=1e-6, rtol=1e-6)
    else:
        assert tparts["aux"].item() == float(jparts["aux"]) == 0.0
    pairs = _by_path(jg, tg)
    assert len(pairs) == len(pytree.tree_leaves(tg))
    for name, got, want in pairs:
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", list(KERNEL_OPS))
def test_remat_runs_each_kernel_forward_twice_and_backward_once(arch):
    """Remat recomputes each layer's forward in the backward pass: each
    kernel op runs twice a layer forward (once without remat) and its
    backward once, and the loss and gradients keep every bit — so the
    recomputed MoE routing claims the slots the first pass claimed."""
    _, tcfg, _, tp, np_batch = _setup(arch, 1)
    op, bwd, kind, per_layer = KERNEL_OPS[arch]
    n = per_layer * tcfg.layer_kinds().count(kind)
    batch = _torch_batch(np_batch)
    runs = {}
    for remat in (False, True):
        with _OpCounts() as counts:
            runs[remat] = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg, remat=remat))(tp,
                                                                                          batch))
        assert counts.n[op] == (2 * n if remat else n), (remat, counts.n)
        assert counts.n[bwd] == n, (remat, counts.n)
    assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_train_step_matches_reference(arch):
    """One step of the port's ``make_train_step`` and of the reference's
    on the same weights and batch: loss, its parts, gradient norm,
    learning rate, clip scale and both moments of every leaf."""
    jcfg, tcfg, jp, tp, np_batch = _setup(arch, 3)
    jtc = jstep.TrainStepConfig(remat=True, warmup_steps=2, total_steps=10)
    jstate = {"params": jp, **jstep.adamw_init(jp, jtc.adamw)}
    jstate, jm = jax.jit(jstep.make_train_step(jcfg, jtc))(
        jstate, {k: jnp.asarray(v) for k, v in np_batch.items()})
    state = {"params": tp, **adamw_init(tp)}
    state, tm = make_train_step(tcfg, TrainStepConfig(remat=True, warmup_steps=2,
                                                      total_steps=10))(state, np_batch)
    for k in ("loss", "ce", "aux", "grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    for tree in ("m", "v"):
        for name, got, want in _by_path(jstate[tree], state[tree]):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_mask_matches_reference(arch):
    """AdamW's decay mask on every leaf of each family (``router`` and
    ``A_log`` decay; ``D``, ``dt_bias``, ``lam``, ``conv_b`` and the norms
    do not): the port's ``_decayable`` against the reference's, leaf by
    leaf, layer indices dropped from both paths."""
    from repro.optim.adamw import _decayable as j_decayable
    from repro_torch.optim.adamw import _decayable as t_decayable

    def names(path):
        return tuple(k for k in (getattr(e, "key", getattr(e, "idx", None)) for e in path)
                     if not isinstance(k, int))

    _, _, jp, tp, _ = _setup(arch)
    want = {names(p): j_decayable(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {names(p): t_decayable(p) for p, _ in pytree.tree_flatten_with_path(tp)[0]}
    assert got == want
    assert any(k[-1] in ("router", "A_log", "lam", "D") for k in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_families_are_trainable(arch):
    """``check_trainable`` takes every family the package serves; a train
    state builds on the smoke config."""
    cfg = get_config(arch, smoke=True)
    tt.check_trainable(cfg)
    state = init_train_state(cfg, 0, device="cpu")
    assert len(state["params"]["layers"]) == cfg.n_layers
    assert int(state["step"]) == 0


def test_parallel_blocks_are_still_refused():
    """The name is kept from when parallel blocks were refused.  Parallel
    attention + FFN blocks (command-r-plus) train; what stays refused
    beside them, by ``_check_arch``, is a parallel block with an encoder
    and cross-attention: without the audio frontend, and with it
    (whisper's structure, whose cross-attention the reference's parallel
    branch would drop)."""
    cfg = get_config("gemma-2b", smoke=True).reduced(parallel_block=True)
    tt.check_trainable(cfg)
    for kw in ({}, {"frontend": "audio"}):
        with pytest.raises(ValueError, match="and the audio .encoder . cross-attention. and "
                                             "vision frontends"):
            tt.check_trainable(cfg.reduced(n_encoder_layers=2, cross_attention=True, **kw))


@pytest.mark.parametrize("arch", list(KERNEL_OPS))
def test_loss_plus_gradient_graph_runs_like_eager(arch):
    """``compile_lm_loss(grad=True)`` for each family: the forward and its
    backward in one graph, each kernel op and its backward op nodes of
    their own kinds (the expert products are gemm nodes); the CPU runtime's
    static plan, dynamic scheduler and ``Graph.execute`` give eager
    autograd's loss and gradients bit for bit."""
    from repro_torch.runtime import Runtime

    _, tcfg, _, _, np_batch = _setup(arch, 4)
    tp = tt.init_params(tcfg, 4, device="cpu")      # the structure the specs have
    shape = ShapeSpec("t", S, B, "train")
    op, bwd, kind, per_layer = KERNEL_OPS[arch]
    n = per_layer * tcfg.layer_kinds().count(kind)
    with Runtime(2, device="cpu") as rt:
        exe = compile_lm_loss(tcfg, shape, backend="host", grad=True, runtime=rt, device="cpu")
        names = collections.Counter(nd.name.split(".")[0].rstrip("_0123456789")
                                    for nd in exe.graph.nodes)
        kinds = collections.Counter(nd.kind for nd in exe.graph.nodes)
        if op == "moe_gmm":
            assert kinds["gemm"] >= 2 * n
        else:
            assert kinds[op] == n and kinds[bwd] == n, kinds
        batch = _torch_batch(np_batch)
        want = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg))(tp, batch))
        inputs = exe.captured.bind((tp, batch))
        runs = [exe.captured.unflatten(exe.execute_host(inputs, host_mode=m).outputs)
                for m in ("static", "dynamic")]
        runs.append(exe.captured.unflatten(exe.graph.execute(inputs)))
    assert names  # the graph has nodes
    for run in runs:
        got = pytree.tree_leaves(run)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_each_family_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --device
    cpu``: the loss graph captured for the Graphi plan, then three steps
    through the trainer, no restart."""
    from repro_torch.launch import train

    assert train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "graphi: loss graph" in out and "done: 3 steps, 0 restarts" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_count_the_active_experts_as_the_reference(arch):
    """``model_train_flops`` (6·N·D) at each family's published width, N the
    active parameters (top-k experts of a MoE arch), equal to the
    reference's."""
    from repro.configs.base import ShapeSpec as JShapeSpec

    jcfg, tcfg = j_get_config(arch), get_config(arch)
    shape = ShapeSpec("t", 512, 4, "train")
    got = tapi.model_train_flops(tcfg, shape)
    assert got == japi.model_train_flops(jcfg, JShapeSpec("t", 512, 4, "train"))
    assert got == 6.0 * tcfg.active_params() * 512 * 4
    if tcfg.n_experts:
        assert tcfg.active_params() < tcfg.n_params()
