"""AdamW (decoupled weight decay) with global-norm clipping, over the port's
param dicts.

The JAX package's ``optim/adamw.py`` op for op: clip every gradient by the
global norm, update f32 moments, bias-correct, add the decay to the delta
of the decayable leaves, step in f32 and round back to each parameter's
dtype.  ``torch.optim.AdamW`` is not used: it rounds in another order and
has no name mask.

Two paths, chosen from what the inputs are, with no option: on the card
the multi-tensor kernels in ``kernels/adamw`` clip and update the whole
tree in a few launches (a DTensor tree through its local shards, the norm
summed over the mesh); CPU, meta and fake tensors, or a capture in
progress (``kernels/adamw/ops.py::refusal``), take the loop over the
leaves, plain tensor ops, as the JAX package leaves its update to XLA: the
kernels' plain version.  Given the same clip scale the two give the same
bits; the kernels' global norm sums in another order.

One difference of form: :func:`adamw_update` writes the new parameters and
moments **in place** (the JAX launcher donates the state to its jitted
step, which XLA then updates in place too).  At gemma-2b's size the state
is 25 GB; a second copy of it would not leave room for the step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import trace
from repro_torch.kernels.adamw import ops as fused

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # moments dtype: fp32 master moments regardless of param dtype
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params: Any, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments shaped like ``params`` (on each leaf's device) and a
    0-dim int32 step counter on the first leaf's device."""
    cfg = cfg or AdamWConfig()

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {
        "m": pytree.tree_map(zeros, params),
        "v": pytree.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each in f32."""
    total = 0
    for leaf in pytree.tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


_NO_DECAY = ("final_norm", "enc_norm", "conv_b", "dt_bias", "lam", "D", "b", "router_bias")


def _decayable(path) -> bool:
    """Weight decay applies to matrices, not to norms/biases/1-d gains: the
    leaf's own key in its dict (list indices skipped) decides."""
    for e in reversed(path):
        if isinstance(e, pytree.MappingKey):
            name = str(e.key)
            return not (name.startswith("ln") or name in _NO_DECAY)
    return True


@torch.no_grad()
def adamw_update(
    grads: Any,
    params: Any,
    opt_state: dict,
    cfg: AdamWConfig | None = None,
    lr: torch.Tensor | float | None = None,
) -> tuple[Any, dict, dict[str, torch.Tensor]]:
    """Returns (params, new_opt_state, metrics).  ``params`` and the
    moments are updated in place and returned; the step counter is a new
    tensor.  ``grads`` has ``params``' structure, in any float dtype.
    With the recorder on (:mod:`repro_torch.core.trace`) the call is the
    span ``optim.adamw``, holding ``optim.clip`` (the global norm and the
    scale) and ``optim.update`` (the leaves' update), and counts the leaves
    each path took in ``optim.fused_leaves`` and ``optim.plain_leaves``."""
    cfg = cfg or AdamWConfig()
    with trace.span("optim.adamw", of=opt_state["step"]):
        step = opt_state["step"] + 1
        dev = step.device
        lr_t = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32, device=dev)

        flat = pytree.tree_flatten_with_path(params)[0]
        paths, p_leaves = [k for k, _ in flat], [x for _, x in flat]
        g_leaves = pytree.tree_leaves(grads)
        m_leaves = pytree.tree_leaves(opt_state["m"])
        v_leaves = pytree.tree_leaves(opt_state["v"])
        if not len(paths) == len(g_leaves) == len(m_leaves) == len(v_leaves):
            raise ValueError("adamw_update: grads, params and moments differ in structure")
        on_card = fused.refusal(p_leaves, g_leaves, m_leaves, v_leaves) is None
        trace.count("optim.fused_leaves", len(paths) if on_card else 0)
        trace.count("optim.plain_leaves", 0 if on_card else len(paths))
        if on_card:
            decay = [bool(cfg.weight_decay) and _decayable(path) for path in paths]
            prep = fused.prepare(p_leaves, g_leaves, m_leaves, v_leaves, decay)

        with trace.span("optim.clip"):
            if on_card:
                gnorm, scale = fused.global_norm_cuda(*prep.norm, cfg.clip_norm, prep.groups)
            else:
                gnorm = global_norm(grads)
                scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

        b1c = 1.0 - torch.pow(cfg.b1, step.float())
        b2c = 1.0 - torch.pow(cfg.b2, step.float())

        with trace.span("optim.update", leaves=len(paths)):
            if on_card:
                fused.adamw_update_cuda(prep.tables, prep.chunks, prep.splits, scale,
                                        *map(fused.local, (lr_t, b1c, b2c)), b1=cfg.b1,
                                        b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
            else:
                for path, p, g, m, v in zip(paths, p_leaves, g_leaves, m_leaves, v_leaves):
                    g = g.float() * scale
                    m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)          # b1 m + (1 - b1) g
                    v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)      # b2 v + (1 - b2) g g
                    del g
                    den = (v / b2c).sqrt_().add_(cfg.eps)            # sqrt(vhat) + eps
                    delta = (m / b1c).div_(den)                      # mhat / den
                    del den
                    if cfg.weight_decay and _decayable(path):
                        delta.add_(cfg.weight_decay * p.float())
                    p.copy_(p.float() - lr_t * delta)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    metrics = {"grad_norm": gnorm, "lr": lr_t, "clip_scale": scale}
    return params, new_state, metrics
