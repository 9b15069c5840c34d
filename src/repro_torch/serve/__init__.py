"""Serving: the paged decode and chunk-prefill step functions, pad-masked
sampling, and the paged-KV engine."""
from .engine import Request, ServeConfig
from .paged import PagedConfig, PagedEngine, PagePool, PoolExhausted
from .step import make_paged_decode_step, make_prefill_chunk_step, mask_pad_vocab, sample_tokens

__all__ = [
    "PagedConfig",
    "PagedEngine",
    "PagePool",
    "PoolExhausted",
    "Request",
    "ServeConfig",
    "make_paged_decode_step",
    "make_prefill_chunk_step",
    "mask_pad_vocab",
    "sample_tokens",
]
