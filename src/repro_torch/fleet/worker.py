"""Fleet worker process: one replica's serve loop.

Importable without torch — the default engine is a pure-stdlib deterministic
toy (next token is a pure function of ``prompt + emitted``), so fleet tests
and the bench spawn workers in well under a second.  Real engines
(:class:`~repro_torch.serve.engine.ContinuousEngine` /
:class:`~repro_torch.serve.paged.PagedEngine`) are built lazily inside the
child process when the fleet is configured with
``engine={"kind": "continuous"|"paged", ...}``; each child holds its own
CUDA context and its own copy of the weights on the card (``"device"`` in
the spec, default ``"cuda"``; a child without a card raises).

Protocol (dicts over a duplex ``multiprocessing.Pipe``):

supervisor -> worker
    ``{"type": "submit", "rid", "prompt", "max_new", "emitted"}``
        start (or *resume* — ``emitted`` is the token prefix already
        streamed by a previous replica) decoding a request
    ``{"type": "cancel", "rid"}``          drop an in-flight request
    ``{"type": "stall", "seconds"}``       fault: block the loop (wedge)
    ``{"type": "mute", "seconds"}``        fault: keep working, stop heartbeats
    ``{"type": "die"}``                    fault: exit without cleanup
    ``{"type": "shutdown"}``               orderly exit

worker -> supervisor
    ``{"type": "ready", "pid"}``           engine built, serving; a real
        engine adds ``"setup_s"``, its set-up seconds by phase (capture,
        calibration, warm-up), so the supervisor can report each boot
    ``{"type": "hb", "inflight", "done_tokens"}``  liveness beacon
    ``{"type": "tokens", "items": [(rid, token, index, done), ...]}``
        one decode step's worth of tokens (batched: one pickle round per
        step, not per token)

Heartbeats are sent from the *main* serve loop — never a side thread — so a
wedged engine (hung op, deadlocked pool) goes silent and the supervisor's
liveness deadline fires.  Determinism contract: decoding is greedy, so the
token at ``index`` depends only on ``prompt + emitted[:index]``; a resumed
request continues on any replica with the same tokens in exact arithmetic
(in bf16 on the card a replayed prefill rounds differently from the decode
steps it replaces, and a near-tie can flip a greedy pick).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# toy engine: deterministic, service-time bound, zero heavy imports
# ---------------------------------------------------------------------------

def toy_next_token(prompt, emitted, vocab_size: int, *, seed: int = 0) -> int:
    """Pure next-token function: a keyed multiplicative hash of the full
    context.  Deterministic across processes and platforms (no floats, no
    RNG state), so a resumed request reproduces the original stream."""
    h = 0x811C9DC5 ^ (seed & 0xFFFFFFFF)
    for t in prompt:
        h = ((h ^ int(t)) * 0x01000193) & 0xFFFFFFFF
    for t in emitted:
        h = ((h ^ int(t)) * 0x01000193) & 0xFFFFFFFF
    return h % max(2, vocab_size)


@dataclass
class _ToyTask:
    rid: int
    prompt: tuple
    max_new: int
    emitted: list = field(default_factory=list)


class ToyEngine:
    """Deterministic single-token-per-step engine.

    Each step decodes one token for every in-flight request and sleeps
    ``service_time_s`` once (the batch is 'fused'), modelling a replica
    whose step cost is service-time bound — which is also what makes fleet
    throughput scale on a box with fewer cores than replicas."""

    def __init__(self, vocab_size: int = 256, service_time_s: float = 0.0,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.service_time_s = service_time_s
        self.seed = seed
        self._tasks: dict[int, _ToyTask] = {}

    def submit(self, rid: int, prompt, max_new: int, emitted=()) -> None:
        self._tasks[rid] = _ToyTask(rid, tuple(prompt), max_new, list(emitted))

    def cancel(self, rid: int) -> None:
        self._tasks.pop(rid, None)

    @property
    def has_work(self) -> bool:
        return bool(self._tasks)

    def step(self):
        """One decode step -> [(rid, token, index, done)] for every task."""
        if not self._tasks:
            return []
        if self.service_time_s > 0:
            time.sleep(self.service_time_s)
        out = []
        for task in list(self._tasks.values()):
            tok = toy_next_token(task.prompt, task.emitted, self.vocab_size,
                                 seed=self.seed)
            idx = len(task.emitted)
            task.emitted.append(tok)
            done = len(task.emitted) >= task.max_new
            if done:
                del self._tasks[task.rid]
            out.append((task.rid, tok, idx, done))
        return out


# ---------------------------------------------------------------------------
# real-engine adapter (lazy torch import; only inside the child process)
# ---------------------------------------------------------------------------

class RealEngineAdapter:
    """Wraps ContinuousEngine/PagedEngine behind the incremental
    submit/step interface the worker loop drives.

    Resume: a request with ``emitted`` tokens already streamed is replayed
    as ``prompt' = prompt + emitted`` with budget ``max_new - len(emitted)``
    — greedy decode continues it with the tokens the original replica
    would have produced (exactly so in f32; see the module docs for bf16).

    ``overrides`` are :class:`ModelConfig` fields to replace (``dtype`` as
    a ``torch`` dtype name, e.g. ``{"dtype": "float32"}``); the weights come
    from ``transformer.init_params(cfg, seed, device=device)``."""

    def __init__(self, engine_kind: str, arch: str, *, smoke: bool = True,
                 max_batch: int = 4, max_len: int = 256,
                 reduced_vocab: int | None = None, seed: int = 0,
                 calibration_store: str | None = None,
                 engine_kwargs: dict | None = None, device: str = "cuda",
                 overrides: dict | None = None):
        import torch  # noqa: PLC0415 — deliberate lazy import (child only)

        from repro_torch.configs.base import get_config
        from repro_torch.device import resolve_device
        from repro_torch.models import transformer
        from repro_torch.serve.engine import Request, ServeConfig

        dev = resolve_device(device)
        cfg = get_config(arch, smoke=smoke)
        if reduced_vocab:
            cfg = cfg.reduced(vocab_size=reduced_vocab)
        if overrides:
            fields = dict(overrides)
            if isinstance(fields.get("dtype"), str):
                fields["dtype"] = getattr(torch, fields["dtype"])
            cfg = cfg.reduced(**fields)
        params = transformer.init_params(cfg, seed, device=dev)
        scfg = ServeConfig(max_batch=max_batch, max_len=max_len,
                           temperature=0.0)
        kw = dict(engine_kwargs or {})
        if calibration_store and "runtime" not in kw:
            # all replicas share one JSON calibration store, so the first
            # worker's profile and schedule search warm every later (re)spawn
            from repro_torch.runtime import Runtime
            kw["runtime"] = Runtime(calibration_path=calibration_store,
                                    device=dev)
        if engine_kind == "paged":
            from repro_torch.serve.paged import PagedConfig, PagedEngine
            pcfg = PagedConfig(page_size=kw.pop("page_size", 16),
                               n_pages=kw.pop("n_pages", None),
                               prefill_chunk=kw.pop("prefill_chunk", 64))
            self.engine = PagedEngine(cfg, params, scfg, paged=pcfg,
                                      device=dev, **kw)
        elif engine_kind == "continuous":
            from repro_torch.serve.engine import ContinuousEngine
            self.engine = ContinuousEngine(cfg, params, scfg, device=dev, **kw)
        else:
            raise ValueError(f"unknown engine kind {engine_kind!r} "
                             "(toy, continuous or paged)")
        self.vocab_size = cfg.vocab_size
        self.setup_s = dict(self.engine.setup_s)
        self._Request = Request
        self._live: dict[int, tuple] = {}   # rid -> (req, base_emitted, n_seen)

    def submit(self, rid: int, prompt, max_new: int, emitted=()) -> None:
        import numpy as np

        emitted = list(emitted)
        full = np.asarray(list(prompt) + emitted, np.int32)
        budget = max_new - len(emitted)
        if budget <= 0:
            return
        req = self._Request(request_id=rid, prompt=full, max_new_tokens=budget)
        self._live[rid] = (req, emitted, 0)
        self.engine.submit(req)

    def cancel(self, rid: int) -> None:
        self._live.pop(rid, None)

    @property
    def has_work(self) -> bool:
        return bool(self._live) and self.engine.has_work

    def step(self):
        if not self.engine.has_work:
            return []
        self.engine.step()
        out = []
        for rid, (req, base, seen) in list(self._live.items()):
            new = req.output[seen:]
            for j, tok in enumerate(new):
                out.append((rid, int(tok), len(base) + seen + j, False))
            seen += len(new)
            if req.done:
                del self._live[rid]
                if out and out[-1][0] == rid:
                    r, t, i, _ = out[-1]
                    out[-1] = (r, t, i, True)
                else:
                    out.append((rid, -1, -1, True))
            else:
                self._live[rid] = (req, base, seen)
        return out


def build_engine(spec: dict):
    """Engine factory from a picklable spec dict (``kind`` selects)."""
    kind = spec.get("kind", "toy")
    if kind == "toy":
        return ToyEngine(vocab_size=spec.get("vocab_size", 256),
                         service_time_s=spec.get("service_time_s", 0.0),
                         seed=spec.get("seed", 0))
    return RealEngineAdapter(
        kind, spec["arch"], smoke=spec.get("smoke", True),
        max_batch=spec.get("max_batch", 4), max_len=spec.get("max_len", 256),
        reduced_vocab=spec.get("reduced_vocab"), seed=spec.get("seed", 0),
        calibration_store=spec.get("calibration_store"),
        engine_kwargs=spec.get("engine_kwargs"),
        device=spec.get("device", "cuda"), overrides=spec.get("overrides"))


# ---------------------------------------------------------------------------
# the serve loop (process entrypoint)
# ---------------------------------------------------------------------------

def worker_main(worker_id: int, conn, engine_spec: dict,
                heartbeat_s: float = 0.1) -> None:
    """Entry point of a fleet worker process (spawn target).

    Drives the engine one step at a time, streaming every token as it is
    decoded; idle polls block briefly on the pipe so a quiet worker costs
    ~0 CPU.  Heartbeats ride the main loop by design (see module docs)."""
    engine = build_engine(engine_spec)
    ready = {"type": "ready", "pid": os.getpid()}
    if getattr(engine, "setup_s", None):
        ready["setup_s"] = engine.setup_s
    conn.send(ready)
    last_hb = 0.0
    mute_until = 0.0
    done_tokens = 0
    inflight = 0

    muted_buf: list[dict] = []

    def send(msg: dict) -> None:
        # the mute fault silences the worker *entirely* (tokens included)
        # while it keeps decoding: a live-but-unreachable replica.  A mute
        # longer than the liveness deadline gets the worker failed over and
        # its requests replayed elsewhere; a shorter blip flushes the
        # buffered stream in order (pipe = reliable transport), so token
        # indices stay contiguous either way.
        if time.monotonic() < mute_until:
            muted_buf.append(msg)
            return
        while muted_buf:
            conn.send(muted_buf.pop(0))
        conn.send(msg)

    def heartbeat(now: float) -> None:
        nonlocal last_hb
        if now - last_hb >= heartbeat_s:
            send({"type": "hb", "inflight": inflight,
                  "done_tokens": done_tokens})
            last_hb = now

    while True:
        # control plane: drain everything pending; block briefly when idle
        while conn.poll(0.0 if engine.has_work else heartbeat_s / 2):
            msg = conn.recv()
            kind = msg["type"]
            if kind == "submit":
                engine.submit(msg["rid"], msg["prompt"], msg["max_new"],
                              msg.get("emitted", ()))
                inflight += 1
            elif kind == "cancel":
                engine.cancel(msg["rid"])
                inflight = max(0, inflight - 1)
            elif kind == "stall":
                time.sleep(msg["seconds"])      # wedge: heartbeats stop
            elif kind == "mute":
                mute_until = time.monotonic() + msg["seconds"]
            elif kind == "die":
                os._exit(17)                    # crash, no cleanup
            elif kind == "shutdown":
                conn.close()
                return

        now = time.monotonic()
        heartbeat(now)
        if not engine.has_work:
            continue
        events = engine.step()
        if events:
            # one message per step, not per token: on small hosts the
            # pickle round-trip dominates the toy service time otherwise
            send({"type": "tokens", "items": events})
            done_tokens += sum(1 for _, _, idx, _ in events if idx >= 0)
            inflight = max(0, inflight - sum(1 for *_, d in events if d))
        heartbeat(time.monotonic())
