"""Serving step functions (what the engines capture) and the shared
next-token sampling."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = [
    "make_decode_step",
    "make_paged_decode_step",
    "make_prefill_chunk_step",
    "make_prefill_step",
    "mask_pad_vocab",
    "sample_tokens",
]


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Prompt prefill into a dense cache (``batch``: ``tokens`` and an
    optional ``valid_len`` for right-padded buckets)."""

    def prefill_step(params, cache, batch):
        return transformer.prefill(cfg, params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One batched decode step over a dense cache (shared or per-slot)."""

    def decode_step(params, cache, tokens):
        return transformer.decode_step(cfg, params, tokens, cache)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig, page_size: int) -> Callable:
    """Batched decode over the block-paged KV cache: each batch row reads and
    writes physical pages through its page-table row (``cache["table"]``);
    rows whose tail page is unmapped write nothing."""

    def paged_decode_step(params, cache, tokens):
        return transformer.paged_decode_step(cfg, params, tokens, cache,
                                             page_size=page_size)

    return paged_decode_step


def make_prefill_chunk_step(cfg: ModelConfig, page_size: int) -> Callable:
    """One page-aligned prompt chunk of a single request: reads context K/V
    from the pools (strictly below ``start``), returns the chunk's K/V
    *without writing* — the engine inserts it afterwards, so this graph can
    run concurrently with the decode step's pool writes."""

    def prefill_chunk_step(params, pages, table_row, batch, start, valid_len):
        return transformer.paged_prefill_chunk(
            cfg, params, batch["tokens"], pages, table_row, start, valid_len,
            page_size=page_size)

    return prefill_chunk_step


def mask_pad_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-inf the padded-vocab tail of ``logits[..., vocab_size:]``: the
    unembedding spans ``cfg.padded_vocab`` columns of random weight, so
    without the mask sampling could emit ids that do not exist."""
    if logits.shape[-1] <= vocab_size:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return torch.where(mask, -torch.inf, logits)


def sample_tokens(
    logits: torch.Tensor,
    vocab_size: int,
    temperature: float,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Next-token ids from last-position logits ``[B, padded_vocab]``.

    Greedy argmax at ``temperature == 0``, else a categorical draw from the
    caller's ``generator`` — both over the pad-masked vocabulary, so every
    emitted id is ``< vocab_size``.
    """
    logits = mask_pad_vocab(logits, vocab_size)
    if temperature > 0:
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)
