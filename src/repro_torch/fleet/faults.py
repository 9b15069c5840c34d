"""Seeded fault injection for the fleet (and the in-process runtime).

Every injector is deterministic given ``seed``: which worker dies, and
when, is a pure function of the spec — so a failing fault drill replays
exactly under ``pytest -k`` with the same seed.

Fleet-level faults (driven by :meth:`FaultInjector.tick` from the
supervisor loop):

``kill``            SIGKILL the victim process (crash mid-decode)
``die``             victim exits abruptly from inside its loop
``stall``           victim's serve loop blocks for ``duration_s`` (wedge:
                    heartbeats stop, liveness deadline fires)
``mute``            victim keeps decoding but drops heartbeats (tests that
                    a live-but-silent replica is still failed over and its
                    requests replay bit-exactly)

Runtime-level fault:

:func:`corrupt_lease_release` double-releases / cross-releases a lease and
returns the runtime's health counters — the admission layer must absorb the
corruption (idempotent release, no double-free) rather than corrupt its
free list.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

__all__ = ["FaultSpec", "FaultInjector", "corrupt_lease_release"]


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``kind``: kill | die | stall | mute.
    ``at_tokens``: fire once the fleet has streamed this many tokens in
    total — "mid-decode" by construction (0 fires immediately).
    ``worker``: victim id, or None to pick one seeded-uniformly among
    workers that currently hold in-flight requests (falling back to any).
    ``duration_s``: stall/mute length.
    """
    kind: str = "kill"
    at_tokens: int = 1
    worker: int | None = None
    duration_s: float = 1.0


class FaultInjector:
    """Ticks alongside :meth:`Fleet.pump`; fires each spec exactly once."""

    def __init__(self, specs, *, seed: int = 0):
        self.specs = list(specs)
        self._rng = random.Random(seed)
        self._fired = [False] * len(self.specs)
        self.log: list[tuple[str, int, int]] = []  # (kind, worker, at_tokens)
        self._tokens = 0
        self._hooked = False

    def _hook(self, fleet) -> None:
        if self._hooked:
            return
        self._hooked = True
        prev = fleet.on_token

        def count(rid, token, index):
            self._tokens += 1
            if prev is not None:
                prev(rid, token, index)

        fleet.on_token = count

    def _victim(self, fleet, spec: FaultSpec) -> int | None:
        if spec.worker is not None:
            return spec.worker if spec.worker in fleet._workers else None
        busy = sorted(w.wid for w in fleet._workers.values() if w.inflight)
        pool = busy or sorted(fleet._workers)
        return self._rng.choice(pool) if pool else None

    def tick(self, fleet) -> None:
        self._hook(fleet)
        for i, spec in enumerate(self.specs):
            if self._fired[i] or self._tokens < spec.at_tokens:
                continue
            wid = self._victim(fleet, spec)
            if wid is None:
                continue
            self._fired[i] = True
            self.log.append((spec.kind, wid, self._tokens))
            if spec.kind == "kill":
                fleet.kill_worker(wid)
            elif spec.kind == "die":
                fleet.send_fault(wid, {"type": "die"})
            elif spec.kind == "stall":
                fleet.send_fault(wid, {"type": "stall",
                                       "seconds": spec.duration_s})
            elif spec.kind == "mute":
                fleet.send_fault(wid, {"type": "mute",
                                       "seconds": spec.duration_s})
            else:
                raise ValueError(f"unknown fault kind {spec.kind!r}")

    @property
    def all_fired(self) -> bool:
        return all(self._fired)


def corrupt_lease_release(runtime, *, width: int = 1) -> dict:
    """Runtime-level fault: release a lease twice, then release executor
    ids that were never leased.  Returns ``runtime.health()`` after the
    abuse; the admission layer counts the bad releases instead of
    corrupting its free list (asserted by the stress tests)."""
    lease = runtime.lease(width)
    ids = lease.executor_ids
    lease.release()
    lease.release()                      # double release: must be a no-op
    runtime._admission.release(ids)      # stale ids: already free
    health = runtime.health()
    # the pool must still be fully usable afterwards
    probe = runtime.lease(width)
    probe.release()
    return health
