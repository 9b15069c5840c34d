"""Fleet supervisor: N replica processes, one router, zero lost requests.

The supervisor owns every worker process (spawn context — each child is a
fresh interpreter, so a crashed replica cannot corrupt the parent) and a
duplex pipe per worker.  It is **single-threaded**: :meth:`pump` dispatches
queued requests, drains worker pipes, and enforces liveness deadlines, so
fleet behaviour is deterministic under test and there are no locks to get
wrong.  Callers either drive :meth:`pump` themselves or use :meth:`run`.

Failure handling — the tentpole contract:

* a worker whose process exits (crash, SIGKILL fault) is detected on the
  next pump via ``Process.is_alive`` / pipe EOF;
* a worker whose process is alive but **silent** past the liveness
  deadline (wedged op, stalled loop, muted heartbeats) is SIGTERMed, given
  ``term_grace_s``, then SIGKILLed;
* either way, its in-flight requests are requeued at the *front* of the
  pending queue with the tokens they already streamed, and replayed on a
  healthy replica as ``prompt + emitted`` — greedy decoding continues the
  stream where it stopped, which :meth:`_on_token` asserts by index (the
  tokens are the uninterrupted stream's in exact arithmetic; see
  :mod:`repro_torch.fleet.worker` for bf16 on the card);
* the dead slot respawns with a bumped generation (bounded by
  ``max_restarts``), and the router forgets its prefix affinity.
"""
from __future__ import annotations

import itertools
import logging
import multiprocessing as mp
import os
import signal
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing.connection import wait as conn_wait

from repro_torch.fleet.router import Router
from repro_torch.fleet.worker import worker_main

_log = logging.getLogger(__name__)

__all__ = ["Fleet", "FleetConfig", "FleetRequest"]


@dataclass(frozen=True)
class FleetConfig:
    """Knobs for a :class:`Fleet`.  ``engine`` is the picklable spec passed
    to :func:`repro_torch.fleet.worker.build_engine` in each child."""
    n_workers: int = 2
    engine: dict = field(default_factory=lambda: {"kind": "toy",
                                                  "vocab_size": 256})
    heartbeat_s: float = 0.05
    liveness_s: float | None = None        # default: 10 * heartbeat_s
    startup_grace_s: float = 60.0          # real engines compile at boot
    term_grace_s: float = 0.5              # SIGTERM -> SIGKILL escalation
    max_inflight_per_worker: int = 4
    affinity_len: int = 16
    max_load_gap: int = 2
    max_restarts: int = 8                  # total respawns across the fleet
    seed: int = 0

    @property
    def effective_liveness_s(self) -> float:
        return self.liveness_s if self.liveness_s is not None \
            else 10.0 * self.heartbeat_s


@dataclass
class FleetRequest:
    rid: int
    prompt: tuple
    max_new: int
    tokens: list = field(default_factory=list)
    done: bool = False
    worker: int | None = None       # current (or last) replica
    n_requeues: int = 0
    _order: int = 0


class _Worker:
    def __init__(self, wid: int, proc, conn, generation: int):
        self.wid = wid
        self.proc = proc
        self.conn = conn
        self.generation = generation
        self.ready = False
        self.spawned = self.last_msg = time.monotonic()
        self.inflight: dict[int, FleetRequest] = {}


class Fleet:
    """Supervised multi-replica serving tier (see module docs)."""

    def __init__(self, cfg: FleetConfig | None = None, **overrides):
        if cfg is None:
            cfg = FleetConfig(**overrides)
        elif overrides:
            raise TypeError("pass FleetConfig or kwargs, not both")
        self.cfg = cfg
        self.router = Router(affinity_len=cfg.affinity_len,
                             max_load_gap=cfg.max_load_gap)
        self._ctx = mp.get_context("spawn")
        self._rid = itertools.count()
        self._workers: dict[int, _Worker] = {}
        self._pending: deque[FleetRequest] = deque()
        self._requests: dict[int, FleetRequest] = {}
        self.completed: list[FleetRequest] = []
        self.events: list[tuple[float, str, int, str]] = []  # (t, kind, wid, why)
        # one entry a replica boot: wid, generation, seconds from spawn to
        # ready, and the engine's set-up seconds by phase (real engines)
        self.boots: list[dict] = []
        self.n_failovers = 0
        self.n_requeued = 0
        self.n_restarts = 0
        self.on_token = None          # optional (rid, token, index) hook
        self._t0 = time.monotonic()
        self._closed = False
        for wid in range(cfg.n_workers):
            self._spawn(wid, generation=0)

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self, wid: int, *, generation: int) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=worker_main,
            args=(wid, child, self.cfg.engine, self.cfg.heartbeat_s),
            name=f"fleet-worker-{wid}.g{generation}", daemon=True)
        proc.start()
        child.close()
        self._workers[wid] = _Worker(wid, proc, parent, generation)
        self.router.add_worker(wid)
        self._event("spawn", wid, f"generation {generation}")

    def _event(self, kind: str, wid: int, why: str) -> None:
        self.events.append((time.monotonic() - self._t0, kind, wid, why))

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, max_new: int) -> int:
        rid = next(self._rid)
        req = FleetRequest(rid=rid, prompt=tuple(int(t) for t in prompt),
                           max_new=max_new, _order=rid)
        self._requests[rid] = req
        self._pending.append(req)
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or any(
            w.inflight for w in self._workers.values())

    def wait_ready(self, timeout_s: float | None = None) -> None:
        """Block until every replica has sent ``ready`` (benches call this
        so spawn/compile time stays out of the measured window)."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.cfg.startup_grace_s)
        while not all(w.ready for w in self._workers.values()):
            if time.monotonic() > deadline:
                slow = [w.wid for w in self._workers.values() if not w.ready]
                raise TimeoutError(f"workers {slow} not ready in time")
            self.pump(timeout=0.05)

    def pump(self, timeout: float = 0.02) -> None:
        """One supervisor iteration: dispatch, drain pipes, enforce
        liveness.  ``timeout`` bounds the pipe wait when nothing is ready."""
        self._dispatch()
        self._poll(timeout)
        self._check_liveness()

    def run(self, requests=None, *, injector=None,
            timeout_s: float = 300.0) -> list[FleetRequest]:
        """Drain all submitted (plus ``requests``) and return them in
        submit order.  ``injector`` is ticked every pump (see faults)."""
        for prompt, max_new in requests or []:
            self.submit(prompt, max_new)
        deadline = time.monotonic() + timeout_s
        while self.has_work:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet did not drain within {timeout_s}s "
                    f"(pending={len(self._pending)}, "
                    f"inflight={sum(len(w.inflight) for w in self._workers.values())})")
            self.pump()
            if injector is not None:
                injector.tick(self)
        done = sorted(self.completed, key=lambda r: r._order)
        self.completed = []
        return done

    def stats(self) -> dict:
        return {
            "n_workers": len(self._workers),
            "generations": {w.wid: w.generation
                            for w in self._workers.values()},
            "n_failovers": self.n_failovers,
            "n_requeued": self.n_requeued,
            "n_restarts": self.n_restarts,
            "router_affinity_hits": self.router.n_affinity_hits,
            "router_routed": self.router.n_routed,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._workers.values():
            try:
                w.conn.send({"type": "shutdown"})
            except (BrokenPipeError, OSError):
                pass
        for w in self._workers.values():
            w.proc.join(timeout=self.cfg.term_grace_s)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=1.0)
            w.conn.close()
        self._workers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- fault-injection surface (used by repro_torch.fleet.faults) ---------
    def send_fault(self, wid: int, msg: dict) -> None:
        w = self._workers.get(wid)
        if w is not None:
            try:
                w.conn.send(msg)
            except (BrokenPipeError, OSError):
                pass

    def kill_worker(self, wid: int) -> None:
        """SIGKILL a replica outright (crash fault)."""
        w = self._workers.get(wid)
        if w is not None and w.proc.is_alive():
            os.kill(w.proc.pid, signal.SIGKILL)

    def worker_inflight(self, wid: int) -> list[FleetRequest]:
        w = self._workers.get(wid)
        return list(w.inflight.values()) if w else []

    # -- internals -----------------------------------------------------------
    def _dispatch(self) -> None:
        while self._pending:
            capacity = {
                w.wid: self.cfg.max_inflight_per_worker - len(w.inflight)
                for w in self._workers.values()
                if w.ready and w.proc.is_alive()
            }
            req = self._pending[0]
            wid = self.router.pick(req.prompt, capacity=capacity)
            if wid is None:
                return
            self._pending.popleft()
            req.worker = wid
            w = self._workers[wid]
            w.inflight[req.rid] = req
            try:
                w.conn.send({"type": "submit", "rid": req.rid,
                             "prompt": list(req.prompt),
                             "max_new": req.max_new,
                             "emitted": list(req.tokens)})
            except (BrokenPipeError, OSError):
                # worker died between liveness checks; fail it now — the
                # request (still in its inflight map) gets requeued
                self._fail(wid, "pipe closed on dispatch")
                return

    def _poll(self, timeout: float) -> None:
        conns = {w.conn: w for w in self._workers.values()}
        if not conns:
            return
        for conn in conn_wait(list(conns), timeout=timeout):
            w = conns[conn]
            try:
                while conn.poll(0):
                    self._handle(w, conn.recv())
            except (EOFError, BrokenPipeError, OSError):
                self._fail(w.wid, "pipe EOF")

    def _handle(self, w: _Worker, msg: dict) -> None:
        w.last_msg = time.monotonic()
        kind = msg["type"]
        if kind == "ready":
            w.ready = True
            self._event("ready", w.wid, f"pid {msg['pid']}")
            self.boots.append({"wid": w.wid, "generation": w.generation,
                               "boot_s": w.last_msg - w.spawned,
                               "setup_s": msg.get("setup_s", {})})
        elif kind == "hb":
            pass
        elif kind == "tokens":
            for rid, token, index, done in msg["items"]:
                if index >= 0:
                    self._on_token(w, rid, token, index)
                if done:
                    req = w.inflight.pop(rid, None)
                    if req is not None:
                        req.done = True
                        self.completed.append(req)
                        self.router.note_done(w.wid)
        else:
            _log.warning("fleet: unknown message %r from worker %d",
                         kind, w.wid)

    def _on_token(self, w: _Worker, rid: int, token: int, idx: int) -> None:
        req = w.inflight.get(rid)
        if req is None:          # token for a request already requeued away
            return
        if idx != len(req.tokens):
            raise AssertionError(
                f"request {req.rid}: worker {w.wid} emitted token index "
                f"{idx}, expected {len(req.tokens)} — replay is not "
                "contiguous (determinism contract broken)")
        req.tokens.append(token)
        if self.on_token is not None:
            self.on_token(req.rid, token, idx)

    def _check_liveness(self) -> None:
        now = time.monotonic()
        for w in list(self._workers.values()):
            if w.proc.exitcode is not None:
                self._fail(w.wid, f"process exited ({w.proc.exitcode})")
                continue
            deadline = (self.cfg.effective_liveness_s if w.ready
                        else self.cfg.startup_grace_s)
            if now - w.last_msg > deadline:
                self._fail(w.wid, f"silent for {now - w.last_msg:.2f}s "
                                  f"(liveness {deadline:.2f}s)")

    def _fail(self, wid: int, why: str) -> None:
        """Declare a replica dead: reap it, requeue its work, respawn."""
        w = self._workers.pop(wid, None)
        if w is None:
            return
        self.n_failovers += 1
        self._event("fail", wid, why)
        _log.warning("fleet: worker %d failed (%s); requeueing %d request(s)",
                     wid, why, len(w.inflight))
        # best-effort drain: tokens already in the pipe shrink the replay
        try:
            while w.conn.poll(0):
                self._handle(w, w.conn.recv())
        except (EOFError, BrokenPipeError, OSError):
            pass
        if w.proc.is_alive():
            w.proc.terminate()                     # SIGTERM
            w.proc.join(timeout=self.cfg.term_grace_s)
            if w.proc.is_alive():
                w.proc.kill()                      # SIGKILL after grace
                w.proc.join(timeout=1.0)
                self._event("sigkill", wid, "term grace expired")
        try:
            w.conn.close()
        except OSError:
            pass
        self.router.remove_worker(wid)
        # requeue in submit order at the front so failed-over requests do
        # not starve behind the backlog
        victims = sorted(w.inflight.values(), key=lambda r: r._order)
        for req in reversed(victims):
            req.worker = None
            req.n_requeues += 1
            self._pending.appendleft(req)
        self.n_requeued += len(victims)
        if self.n_restarts < self.cfg.max_restarts:
            self.n_restarts += 1
            self._spawn(wid, generation=w.generation + 1)
        elif not self._workers:
            raise RuntimeError(
                f"fleet: every replica is dead and the restart budget "
                f"({self.cfg.max_restarts}) is spent (last failure: {why})")
