"""Learning-rate schedules: the JAX package's ``optim/schedule.py`` on
tensors (a 0-dim step tensor in, a 0-dim f32 learning rate out, on the
step's device), so a train step never reads the step back to the host."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step: torch.Tensor, base_lr: float, total_steps: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def linear_warmup_cosine(step: torch.Tensor, base_lr: float, warmup_steps: int,
                         total_steps: int, min_frac: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = base_lr * s / max(warmup_steps, 1)
    decay = cosine_schedule(step - warmup_steps, base_lr, max(total_steps - warmup_steps, 1),
                            min_frac)
    return torch.where(s < warmup_steps, warm, decay)
