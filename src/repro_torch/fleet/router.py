"""Request router: prefix affinity first, load second.

The router is pure bookkeeping — it never touches pipes or processes — so
it is unit-testable without a fleet and deterministic given the same call
sequence.  Affinity uses the same notion of "shareable prefix" as the
paged engine's prefix cache: the first ``affinity_len`` prompt tokens,
hashed.  A replica that has already prefilled that prefix serves a new
request with it faster (shared pages / warm calibration), so the router
prefers it unless the load gap to the least-loaded replica exceeds
``max_load_gap`` in-flight requests — affinity must never create a hotspot.
"""
from __future__ import annotations

import hashlib
from collections import defaultdict

__all__ = ["Router"]


def _prefix_key(prompt, affinity_len: int) -> str:
    head = bytes(int(t) & 0xFF for t in list(prompt)[:affinity_len])
    return hashlib.blake2s(head, digest_size=8).hexdigest()


class Router:
    def __init__(self, *, affinity_len: int = 16, max_load_gap: int = 2):
        self.affinity_len = affinity_len
        self.max_load_gap = max_load_gap
        self._prefixes: dict[int, set[str]] = defaultdict(set)
        self._load: dict[int, int] = defaultdict(int)
        self.n_affinity_hits = 0
        self.n_routed = 0

    # -- lifecycle events fed by the supervisor -----------------------------
    def add_worker(self, wid: int) -> None:
        self._load.setdefault(wid, 0)
        self._prefixes.setdefault(wid, set())

    def remove_worker(self, wid: int) -> None:
        """A replica died: its prefix cache is gone and its in-flight load
        is meaningless — drop both (requeued requests re-route fresh)."""
        self._prefixes.pop(wid, None)
        self._load.pop(wid, None)

    def note_done(self, wid: int) -> None:
        if wid in self._load and self._load[wid] > 0:
            self._load[wid] -= 1

    # -- the decision -------------------------------------------------------
    def pick(self, prompt, *, capacity: dict[int, int]) -> int | None:
        """Choose a worker id for ``prompt``.

        ``capacity`` maps worker id -> remaining admission slots; workers at
        zero are skipped.  Returns None when every replica is full (caller
        keeps the request queued).  Deterministic: ties break on worker id.
        """
        live = sorted(w for w, c in capacity.items() if c > 0 and w in self._load)
        if not live:
            return None
        key = _prefix_key(prompt, self.affinity_len)
        least = min(self._load[w] for w in live)
        chosen = None
        for w in live:
            if key in self._prefixes[w] and (
                    self._load[w] - least <= self.max_load_gap):
                chosen = w
                self.n_affinity_hits += 1
                break
        if chosen is None:
            chosen = min(live, key=lambda w: (self._load[w], w))
        self._load[chosen] += 1
        self._prefixes[chosen].add(key)
        self.n_routed += 1
        return chosen
