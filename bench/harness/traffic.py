"""The general generator of training batches, driven by a mix's parameters.

The benchmark's own copy of the port's ``data/pipeline.py``
``SyntheticTokens``, rewritten to run on the device: a batch is a pure
function of ``(seed, step)``, rows of ``seq_len + 1`` ids whose first
``seq_len`` are the tokens and last ``seq_len`` the next-token labels.
Rows are packed full (no padding, no document boundary).  Token laws
(``tokens.law`` in the mix):

* ``zipf``: id ``r - 1`` with probability proportional to ``r ** -a`` over
  the vocabulary (a few ids take most of the text, as in natural text);
* ``uniform``: every id alike.
"""
from __future__ import annotations

import torch

from harness.weights import derive


def _law(tokens: dict, vocab: int, device) -> torch.Tensor | None:
    if tokens["law"] == "uniform":
        return None
    if tokens["law"] == "zipf":
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        p = ranks ** -float(tokens["a"])
        return (p / p.sum()).float()
    raise ValueError(f"unknown token law {tokens['law']!r}")


def batches(mix: dict, vocab: int, seed: int, steps, device) -> list[dict]:
    """The batches of ``steps`` (step indices) for ``mix``, on ``device``."""
    B, S = int(mix["batch"]), int(mix["seq_len"])
    probs = _law(mix["tokens"], vocab, device)
    out = []
    for step in steps:
        gen = torch.Generator(device=device).manual_seed(derive(seed, "batch", int(step)))
        if probs is None:
            ids = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
        else:
            ids = torch.multinomial(probs, B * (S + 1), replacement=True,
                                    generator=gen).reshape(B, S + 1)
        ids = ids.to(torch.int32)
        out.append({"tokens": ids[:, :S].contiguous(), "labels": ids[:, 1:].contiguous()})
    return out
