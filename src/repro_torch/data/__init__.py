"""Synthetic, step-indexed token batches (numpy)."""
from .pipeline import DataConfig, Prefetcher, SyntheticTokens, make_pipeline

__all__ = ["DataConfig", "Prefetcher", "SyntheticTokens", "make_pipeline"]
