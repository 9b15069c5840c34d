"""The reference follows the program's first training steps: the same
weights and batches, its loss and gradients from the configuration's plain
reference, then AdamW as the port states it (clip by the global norm,
float32 moments, bias correction, decoupled decay on the matrices, the
step in float32, each parameter rounded back to its own dtype), with the
learning rate of a linear warm-up and a cosine decay.

It gives the three readings the check compares: each step's loss, each
leaf's norm of the first gradient as AdamW takes it (after clipping), and
each leaf's norm of its change after the steps.  Imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch


def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay to
    a tenth of it at ``total_steps`` (step counts from 1)."""
    base, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return base * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * t)))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


@torch.no_grad()
def adamw(params: dict, grads: dict, moments: dict, step: int, opt: dict, decays) -> float:
    """One AdamW step in place over ``params`` (each in its own dtype);
    returns the clip scale."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
    b1, b2, lr = opt["b1"], opt["b2"], learning_rate(step, opt)
    b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
    for path, p in params.items():
        g = grads[path] * scale
        m, v = moments.setdefault(path, (torch.zeros_like(g), torch.zeros_like(g)))
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        delta = (m / b1c) / ((v / b2c).sqrt() + opt["eps"])
        if opt["weight_decay"] and decays(path):
            delta = delta + opt["weight_decay"] * p.float()
        p.copy_(p.float() - lr * delta)
    return scale


def follow(ref, model: dict, params: dict, batches: list, opt: dict, *,
           precision: str = "fp32", initial=None) -> dict:
    """Run ``len(batches)`` steps of the reference ``ref`` from ``params``
    (updated in place).  ``initial(path)`` gives a leaf's starting value
    for the change; without it a copy is kept.  Returns the readings:
    ``loss`` per step, ``grad`` (step 1, clipped) and ``raw_grad`` (step 1,
    unclipped) norms by path, ``change`` norms by path, ``kept`` (MoE
    claims kept per layer, per step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = None if initial is not None else {k: v.clone() for k, v in params.items()}
    moments: dict = {}
    out = {"loss": [], "grad": {}, "raw_grad": {}, "change": {}, "kept": []}
    for i, batch in enumerate(batches, start=1):
        loss, grads, kept = ref.loss_and_grads(model, params, batch, precision)
        out["loss"].append(loss)
        out["kept"].append(kept)
        if i == 1:
            out["raw_grad"] = {p: _norm(g) for p, g in grads.items()}
        scale = adamw(params, grads, moments, i, opt, ref.decays)
        if i == 1:
            out["grad"] = {p: n * scale for p, n in out["raw_grad"].items()}
        del grads
    for path, p in params.items():
        p0 = initial(path) if initial is not None else start[path]
        out["change"][path] = _norm(p.float() - p0.float())
    return out
