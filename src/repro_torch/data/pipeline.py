"""Deterministic synthetic token pipeline (sharded, prefetched).

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy only,
so the same batches come out of both, bit for bit).  Batches stay numpy;
the trainer's step moves them to its device.

Fault-tolerance contract: batches are a pure function of ``(seed, step)`` —
no iterator state — so a trainer restarted from a step-k checkpoint consumes
exactly the token stream it would have seen without the failure, on any host
count (each host slices its rows from the same global batch).

The default generator is a noisy bigram chain over the vocab: structured
enough that an LM's loss visibly descends within a few hundred steps (the
end-to-end example's acceptance check), stochastic enough that it cannot be
memorized to zero loss.
"""
from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_log = logging.getLogger(__name__)

IGNORE = -1

__all__ = ["DataConfig", "SyntheticTokens", "Prefetcher", "make_pipeline"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "bigram"      # bigram | uniform | copy
    bigram_noise: float = 0.1


class SyntheticTokens:
    """Stateless step-indexed batch source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(np.random.Philox(cfg.seed))
        # fixed bigram successor table + a second table for the noise mixture
        self._table = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size, dtype=np.int64)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for ``step``: tokens + next-token labels [B, S]."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.Philox(key=cfg.seed + 1, counter=step))
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1), dtype=np.int64)
        elif cfg.kind == "copy":
            half = (S + 1) // 2 + 1
            head = rng.integers(0, cfg.vocab_size, size=(B, half), dtype=np.int64)
            toks = np.concatenate([head, head], axis=1)[:, : S + 1]
        elif cfg.kind == "bigram":
            toks = np.empty((B, S + 1), dtype=np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
            noise = rng.random((B, S)) < cfg.bigram_noise
            randoms = rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int64)
            for t in range(S):
                nxt = self._table[toks[:, t]]
                toks[:, t + 1] = np.where(noise[:, t], randoms[:, t], nxt)
        else:
            raise ValueError(f"unknown data kind {self.cfg.kind!r}")
        tokens = toks[:, :S].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def host_batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict[str, np.ndarray]:
        """This host's row-slice of the global batch (multi-controller)."""
        g = self.batch(step)
        B = self.cfg.global_batch
        if B % n_hosts != 0:
            raise ValueError(
                f"global batch {B} not divisible by {n_hosts} hosts")
        per = B // n_hosts
        lo = host_id * per
        return {k: v[lo : lo + per] for k, v in g.items()}

    def stream(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a step-indexed source (depth-bounded).

    The TPU input pipeline analogue: host CPU builds batch k+1..k+depth while
    the device runs step k.  ``get(step)`` preserves the stateless contract —
    out-of-order or repeated requests (restart!) fall back to direct calls.
    """

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: int = 2):
        self.source = source
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next_to_produce = start_step
        self._stop = threading.Event()
        self._stage = "starting"      # what the producer is doing right now
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while not self._stop.is_set():
            step = self._next_to_produce
            self._stage = f"generate(step={step})"
            batch = self.source.batch(step)
            self._next_to_produce = step + 1
            self._stage = f"enqueue(step={step})"
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
        self._stage = "stopped"

    def get(self, step: int) -> dict[str, np.ndarray]:
        while True:
            try:
                s, batch = self._q.get_nowait()
            except queue.Empty:
                return self.source.batch(step)
            if s == step:
                return batch
            if s > step:          # restart to an earlier step: direct call
                return self.source.batch(step)
            # s < step: stale entry (skipped ahead) — drop and keep draining

    def close(self, timeout: float = 2.0) -> None:
        """Stop the producer and join it.  A producer that fails to exit
        within ``timeout`` (e.g. a wedged generator) is abandoned — it is a
        daemon thread — but close names the stage it is stuck in rather than
        returning silently, so leaks are attributable."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            _log.warning(
                "Prefetcher.close: producer thread did not exit within "
                "%.1fs — stuck in %s; abandoning daemon thread",
                timeout, self._stage)


def make_pipeline(cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
    src = SyntheticTokens(cfg)
    return Prefetcher(src, start_step=start_step, depth=prefetch) if prefetch else src
