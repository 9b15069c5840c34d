"""Serving: the prefill / decode step functions, pad-masked sampling, the
per-slot continuous-batching and wave engines, and the paged-KV engine."""
from .engine import ContinuousEngine, Request, ServeConfig, ServeEngine
from .paged import PagedConfig, PagedEngine, PagePool, PoolExhausted
from .step import (make_decode_step, make_paged_decode_step, make_prefill_chunk_step,
                   make_prefill_step, mask_pad_vocab, sample_tokens)

__all__ = [
    "ContinuousEngine",
    "PagedConfig",
    "PagedEngine",
    "PagePool",
    "PoolExhausted",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "make_decode_step",
    "make_paged_decode_step",
    "make_prefill_chunk_step",
    "make_prefill_step",
    "mask_pad_vocab",
    "sample_tokens",
]
