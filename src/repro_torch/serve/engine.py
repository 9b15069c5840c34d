"""Request and engine configuration types shared by the serving engines,
with submit-time validation and pad-masked sampling.

The JAX package's per-slot ``ContinuousEngine`` and wave ``ServeEngine``
live beside these in its ``serve/engine.py``; they are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.step import sample_tokens

__all__ = ["Request", "ServeConfig"]


def _validate_submit(req: "Request", scfg: "ServeConfig") -> None:
    """Shared submit-time validation."""
    if len(req.prompt) == 0:
        raise ValueError(f"request {req.request_id}: empty prompt")
    if req.max_new_tokens <= 0:
        raise ValueError(
            f"request {req.request_id}: max_new_tokens must be positive "
            f"(got {req.max_new_tokens})"
        )
    if len(req.prompt) + req.max_new_tokens > scfg.max_len:
        raise ValueError(
            f"request {req.request_id}: prompt ({len(req.prompt)}) + "
            f"max_new_tokens ({req.max_new_tokens}) exceeds max_len "
            f"({scfg.max_len})"
        )


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine:
    output: list[int] = field(default_factory=list)
    done: bool = False
    _order: int = field(default=-1, repr=False, compare=False)


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8              # slot capacity
    max_len: int = 512
    temperature: float = 0.0        # 0 => greedy
    pad_id: int = 0


class _SamplerMixin:
    """Shared pad-masked sampling (greedy, or temperature from the engine's
    own ``torch.Generator``)."""

    cfg: ModelConfig
    scfg: ServeConfig
    _gen: torch.Generator

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        gen = self._gen if self.scfg.temperature > 0 else None
        toks = sample_tokens(logits, self.cfg.vocab_size, self.scfg.temperature, gen)
        return toks.to(torch.int32).cpu().numpy()
