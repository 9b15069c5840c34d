"""The train step: loss -> grad -> AdamW, with microbatch gradient
accumulation and per-layer remat — the JAX package's ``train/step.py``.

State layout (a flat dict, as the reference's):

    {"params": ..., "m": ..., "v": ..., "step": int32 0-dim}

Microbatching splits every batch leaf [B, ...] into ``n_micro`` row blocks
and accumulates f32 grads over them in a loop (the reference's
``lax.scan``); it also bounds activation memory to one microbatch.  Each
step updates the state **in place** (``optim.adamw``) and returns it; the
batch may be numpy (the data pipeline's), moved onto the state's device
here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import trace
from repro_torch.models import api as model_api
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

__all__ = [
    "TrainStepConfig",
    "init_train_state",
    "make_train_step",
    "lm_loss_fn",
    "value_and_grad",
    "param_specs",
    "compile_lm_loss",
]


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_dtype: torch.dtype = torch.float32    # accumulation dtype


def init_train_state(cfg: ModelConfig, seed: int | torch.Generator = 0,
                     adamw_cfg: AdamWConfig | None = None, *,
                     device: str | torch.device = "cuda") -> dict:
    """Random weights (``transformer.init_params``) and zero AdamW state on
    ``device`` (the card unless the caller asks for the CPU)."""
    from repro_torch.models import transformer

    transformer.check_trainable(cfg)
    params = transformer.init_params(cfg, seed, device=device)
    opt = adamw_init(params, adamw_cfg)
    return {"params": params, **opt}


def lm_loss_fn(model_cfg: ModelConfig, *, remat: bool = False) -> Callable:
    """The scalar LM loss as a plain ``(params, batch) -> loss`` callable —
    the capture target for ``repro_torch.compile``."""

    def loss(params, batch):
        return model_api.lm_loss(model_cfg, params, batch, remat=remat)[0]

    loss.__name__ = f"{model_cfg.name}.lm_loss"
    return loss


def value_and_grad(fn: Callable, *, has_aux: bool = False,
                   unread: frozenset[str] = frozenset()) -> Callable:
    """``jax.value_and_grad`` of ``fn(params, batch)`` w.r.t. ``params``:
    ``(params, batch) -> (loss, grads)`` (``((loss, aux), grads)`` with
    ``has_aux``), grads in ``params``' structure, detached.  A leaf the
    loss does not read raises, unless its key path is in ``unread``
    (``transformer.unread_params``): that leaf gets zeros, as ``jax.grad``
    gives it.

    It runs ``torch.autograd.grad`` on copies of the leaves that require
    grad, so ``make_fx`` capture traces the backward's ops as well (the
    way AOTAutograd builds its joint graph; ``torch.func.grad`` does not
    take the kernels' custom autograd registrations).  The forward and the
    backward are the spans ``train.forward`` and ``train.backward``
    (:mod:`repro_torch.core.trace`; keyword arguments become their
    attributes)."""

    def value_and_grad(params, batch, **attrs):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            with trace.span("train.forward", of=leaves[0], **attrs):
                out = fn(pytree.tree_unflatten(live, spec), batch)
            loss = out[0] if has_aux else out
            with trace.span("train.backward", of=leaves[0], **attrs):
                if unread:
                    grads = list(torch.autograd.grad(loss, live, allow_unused=True))
                    for i, kp in enumerate(pytree.tree_flatten_with_path(params)[0]):
                        if grads[i] is None:
                            if pytree.keystr(kp[0]) not in unread:
                                raise RuntimeError(
                                    f"the loss does not read {pytree.keystr(kp[0])}")
                            grads[i] = torch.zeros_like(live[i])
                else:
                    grads = torch.autograd.grad(loss, live)
        grads = pytree.tree_unflatten(list(grads), spec)
        if has_aux:
            return (loss.detach(), pytree.tree_map(torch.Tensor.detach, out[1])), grads
        return loss.detach(), grads

    value_and_grad.__name__ = f"{getattr(fn, '__name__', 'fn')}+grad"
    return value_and_grad


def param_specs(cfg: ModelConfig, *, device: str | torch.device = "cuda",
                fake_mode=None) -> dict:
    """Fake-tensor stand-ins for ``transformer.init_params(cfg)`` on
    ``device``: the shapes and dtypes, nothing allocated (the reference's
    ``jax.eval_shape``), in ``fake_mode`` (a new ``FakeTensorMode`` when
    None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.device import resolve_device
    from repro_torch.models import transformer

    dev = resolve_device(device)
    with fake_mode or FakeTensorMode(allow_non_fake_inputs=True):
        return transformer.init_params(cfg, torch.Generator(), device=dev)


def compile_lm_loss(
    model_cfg: ModelConfig,
    shape: ShapeSpec,
    *,
    hw=None,
    backend: str = "host",
    remat: bool = False,
    grad: bool = False,
    runtime=None,
    device: str | torch.device = "cuda",
    **kw: Any,
):
    """``repro_torch.compile`` the loss graph of a model at an input shape.

    Captures on fake-tensor specs on ``device`` (no allocation); the
    port's layers are a per-layer list, so the scheduler always sees the
    per-layer operator DAG (the reference's ``unroll_layers``).
    ``grad=True`` captures ``value_and_grad`` instead — the paper's "one
    complete execution = one training iteration" graph, with the backward
    kernels' ops as nodes.  ``runtime`` binds the executable to a shared
    :class:`repro_torch.Runtime` (the process default otherwise)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import api as graphi
    from repro_torch.core.cost_model import KNL7250

    fn = lm_loss_fn(model_cfg, remat=remat)
    if grad:
        fn = value_and_grad(fn, unread=transformer.unread_params(model_cfg))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params_spec = param_specs(model_cfg, device=device, fake_mode=mode)
    batch_spec = model_api.input_specs(model_cfg, shape, kind="train", device=device,
                                       fake_mode=mode)
    return graphi.compile(
        fn, params_spec, batch_spec,
        hw=hw or KNL7250, backend=backend, runtime=runtime,
        name=f"{model_cfg.name}.lm_loss" + ("+grad" if grad else ""),
        **kw,
    )


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(
    model_cfg: ModelConfig, tcfg: TrainStepConfig | None = None
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned.  With the recorder on
    (:mod:`repro_torch.core.trace`) a step is the root span ``train.step``
    holding ``train.batch`` (the copy to the device), ``train.forward``
    and ``train.backward`` (one each a microbatch, then
    ``train.accumulate``) and ``train.optimizer`` (the schedule and
    AdamW)."""
    tcfg = tcfg or TrainStepConfig()

    def loss_fn(params, mb):
        return model_api.lm_loss(model_cfg, params, mb, remat=tcfg.remat)

    vg = value_and_grad(loss_fn, has_aux=True, unread=transformer.unread_params(model_cfg))

    def value_and_grads(params, mb, **attrs):
        (loss, parts), grads = vg(params, mb, **attrs)
        return loss, parts, pytree.tree_leaves(grads)

    def grads_of(params, batch):
        n = tcfg.microbatches
        if n == 1:
            loss, parts, grads = value_and_grads(params, batch)
            # AdamW's first op on a gradient is an f32 cast: an f32 cast here
            # would change no bit and hold a second, f32 copy of the grads
            if tcfg.grad_dtype != torch.float32:
                grads = [g.to(tcfg.grad_dtype) for g in grads]
            return grads, loss, parts
        for k, x in batch.items():
            if x.shape[0] % n != 0:
                raise ValueError(f"batch {x.shape[0]} ({k}) not divisible by microbatches {n}")
        g_acc = None
        loss_acc = ce_acc = aux_acc = torch.zeros((), dtype=torch.float32)
        for i in range(n):
            mb = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
                  for k, x in batch.items()}
            loss, parts, g = value_and_grads(params, mb, micro=i)
            with trace.span("train.accumulate", of=loss, micro=i):
                if g_acc is None:
                    g_acc = [torch.zeros(p.shape, dtype=tcfg.grad_dtype, device=p.device)
                             for p in pytree.tree_leaves(params)]
                    loss_acc = ce_acc = aux_acc = torch.zeros((), dtype=torch.float32,
                                                              device=loss.device)
                for a, b in zip(g_acc, g):
                    a.add_(b.to(tcfg.grad_dtype))
                loss_acc = loss_acc + loss
                ce_acc = ce_acc + parts["ce"]
                aux_acc = aux_acc + parts["aux"]
        with trace.span("train.accumulate", of=loss):
            inv = 1.0 / n
            grads = [x * inv for x in g_acc]
            return grads, loss_acc * inv, {"ce": ce_acc * inv, "aux": aux_acc * inv}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        with trace.span("train.step", of=state["step"], root=True):
            params = state["params"]
            with trace.span("train.batch"):
                batch = _on(batch, state["step"].device)
            grads, loss, parts = grads_of(params, batch)
            grads = pytree.tree_unflatten(grads, pytree.tree_structure(params))
            with trace.span("train.optimizer"):
                lr = linear_warmup_cosine(
                    state["step"] + 1, tcfg.adamw.lr, tcfg.warmup_steps, tcfg.total_steps
                )
                opt_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
                new_params, new_opt, om = adamw_update(grads, params, opt_state, tcfg.adamw,
                                                       lr=lr)
            new_state = {"params": new_params, **new_opt}
            metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"], **om}
            return new_state, metrics

    return train_step
