"""Serving engines on one device: the per-slot continuous-batching engine,
the wave batcher, and the request / configuration types all engines share.

:class:`ContinuousEngine` — the latency-oriented engine: a persistent
decode loop over a fixed-capacity per-slot KV cache
(``transformer.init_cache(per_slot=True)``).  Each batch row is a request
*slot* at its own decode position; new requests' prefills are admitted into
free slots **between decode steps** — overlapped with the in-flight decode
on the same executor lease — and a finished request frees its slot
immediately on EOS/budget.  Prefill and decode are captured via
``repro_torch.api.compile``; the profiler's configuration search picks the
executor count at engine construction, and steady-state decode steps replay
a compiled static host plan.

:class:`ServeEngine` — the throughput-oriented wave batcher kept as the
baseline: requests are grouped into waves of equal prompt length, one
batched prefill, then batched decode until every member finishes.  It runs
the model functions eagerly (the reference ``jax.jit`` s them; PyTorch
needs no counterpart).

On a CUDA device every prefill attention runs kernel B3
(``kernels/flash_attention``) and every decode attention kernel B2
(``kernels/decode_attention``, per-row form in the slot engine, shared form
in the wave engine); a Mamba layer's scan runs kernel B6
(``kernels/ssm_scan``) and an RG-LRU layer's recurrence kernel B7
(``kernels/rglru_scan``), in prefill and decode alike.  Idle slots of a
recurrent arch decode the pad token and so advance their state; the next
insert overwrites it wholesale.  Both engines run on the card unless
built with ``device="cpu"``, and sample over the pad-masked vocabulary, so
emitted ids are always ``< cfg.vocab_size``.  The paged engine lives in
``serve/paged.py``.  The JAX package's engines are the parity reference
(tests/test_torch_slot_serve.py).

Frontend archs, as in the reference: the slot engine refuses them
(:func:`refuse_frontend`); the wave engine prefills tokens only, so it
serves llava as text and refuses whisper, whose prefill needs the
encoder's frames (:func:`refuse_encoder`).  Both are served with their
embeddings through ``serve/step.py``'s steps, eager or compiled.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import H100, HardwareModel
from repro_torch.core.engine import ExecutorPool
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.runtime import Runtime, default_runtime
from repro_torch.serve.step import make_decode_step, make_prefill_step, sample_tokens

__all__ = ["ContinuousEngine", "Request", "ServeConfig", "ServeEngine", "refuse_encoder",
           "refuse_frontend"]


def refuse_frontend(cfg: ModelConfig) -> None:
    """The slot engine's refusal of a frontend arch, the reference's
    ``ValueError``: its requests carry tokens only."""
    if cfg.frontend:
        raise ValueError("continuous batching supports decoder-only archs "
                         f"(got frontend={cfg.frontend!r})")


def refuse_encoder(cfg: ModelConfig) -> None:
    """The wave engine's refusal of an encoder arch (whisper): a wave
    request carries no encoder input, and its prefill needs
    ``batch["frames"]`` (the reference raises a ``KeyError`` there)."""
    if cfg.frontend == "audio":
        raise ValueError(
            f"{cfg.name}: wave requests carry no encoder input (its prefill needs "
            "batch['frames']); serve it through serve.step's make_prefill_step / "
            "make_decode_step")


def _validate_submit(req: "Request", scfg: "ServeConfig") -> None:
    """Shared submit-time validation."""
    if len(req.prompt) == 0:
        raise ValueError(f"request {req.request_id}: empty prompt")
    if req.max_new_tokens <= 0:
        raise ValueError(
            f"request {req.request_id}: max_new_tokens must be positive "
            f"(got {req.max_new_tokens})"
        )
    if len(req.prompt) + req.max_new_tokens > scfg.max_len:
        raise ValueError(
            f"request {req.request_id}: prompt ({len(req.prompt)}) + "
            f"max_new_tokens ({req.max_new_tokens}) exceeds max_len "
            f"({scfg.max_len})"
        )


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine:
    output: list[int] = field(default_factory=list)
    done: bool = False
    _order: int = field(default=-1, repr=False, compare=False)


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8              # wave width / continuous slot capacity
    max_len: int = 512
    temperature: float = 0.0        # 0 => greedy
    pad_id: int = 0


class _SamplerMixin:
    """Shared pad-masked sampling (greedy, or temperature from the engine's
    own ``torch.Generator``)."""

    cfg: ModelConfig
    scfg: ServeConfig
    _gen: torch.Generator

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        gen = self._gen if self.scfg.temperature > 0 else None
        toks = sample_tokens(logits, self.cfg.vocab_size, self.scfg.temperature, gen)
        return toks.to(torch.int32).cpu().numpy()


class _GraphEngine(_SamplerMixin):
    """What the engines driven by Graphi executables share: per-step
    executor leases, running a captured graph on them, planning the decode
    graph's executor config, and request submission into ``pending``."""

    device: torch.device
    pool: ExecutorPool | None
    runtime: Runtime | None
    pending: deque
    _decode_exe: "object"
    _step_deadline: float | None
    _step_lease_ids: tuple[int, ...]

    def _dev(self, a) -> torch.Tensor:
        """A host int array as an int32 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _plan_decode(self, zero_args, max_executors: int | None) -> None:
        """Profile the decode graph — from a calibration-store hit, else by
        timing every node on ``zero_args()`` (the paper's first-iterations
        profiling) — pick the executor count (bounded by ``max_executors``,
        the pool or the runtime) and, in static mode, freeze the plan now at
        that width."""
        exe = self._decode_exe
        if exe.calibrated:
            kw = {"max_executors": max_executors} if max_executors is not None else {}
            self.profile = exe.profile_with(**kw)
        else:
            self.profile = exe.calibrate(*zero_args(), max_executors=max_executors)
        n_exec = exe.planned_executors
        if max_executors is not None:
            n_exec = max(1, min(n_exec, max_executors))
        if self.pool is not None:
            n_exec = min(n_exec, self.pool.n_executors)
        elif self.runtime is not None:
            n_exec = min(n_exec, self.runtime.n_workers)
        self.n_executors = n_exec
        self._step_lease_ids = ()
        if exe.host_mode == "static":
            exe.host_plan(n_exec)
        self._team_size = self.profile.best_team_size

    def _step_pool(self):
        """The executors one engine iteration runs on: the explicit shared
        pool, or a fresh lease of the engine's calibrated width (the previous
        step's executor ids are the affinity hint, so the steady-state loop
        keeps its warm executor threads)."""
        if self.pool is not None:
            return nullcontext(self.pool)
        lease = self.runtime.lease(self.n_executors, prefer=self._step_lease_ids)
        self._step_lease_ids = lease.executor_ids
        return lease

    def _run_exe(self, exe, args: tuple, *, pool, host_mode: str | None = None):
        """Execute a captured engine graph on the step's executors and
        unflatten to the fn's output pytree."""
        res = exe.execute_host(
            exe.captured.bind(args), n_executors=self.n_executors,
            pool=pool, host_mode=host_mode, deadline=self._step_deadline,
        )
        return exe.captured.unflatten(res.outputs)

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        """Nothing to release: executors are leased per step (an explicit
        ``pool`` is the caller's to close)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, req: Request) -> None:
        _validate_submit(req, self.scfg)
        req._order = self._n_submitted
        self._n_submitted += 1
        self.pending.append(req)


class ServeEngine(_SamplerMixin):
    """Length-bucketed wave batcher (the throughput baseline).

    The KV cache's slot-position table is shared across a wave, so waves are
    bucketed to *equal prompt length* — batched decode stays bit-identical
    to unbatched.  A wave stalls on its slowest member; for latency under
    staggered arrivals use :class:`ContinuousEngine`.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device: str | torch.device = "cuda", rng_seed: int = 0):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.queue: list[Request] = []
        self._n_submitted = 0
        self._gen = torch.Generator(device=dev).manual_seed(rng_seed)
        # loop counters (benchmarks read these)
        self.n_waves = 0
        self.n_decode_steps = 0
        self.decode_step_s: list[float] = []   # host wall time per decode step

    def submit(self, req: Request) -> None:
        _validate_submit(req, self.scfg)
        req._order = self._n_submitted
        self._n_submitted += 1
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    def stats(self) -> dict:
        return {"n_waves": self.n_waves, "n_decode_steps": self.n_decode_steps}

    # -- one wave -------------------------------------------------------------
    def _run_wave(self, wave: Sequence[Request]) -> None:
        cfg, scfg, dev = self.cfg, self.scfg, self.device
        refuse_encoder(cfg)
        B = len(wave)
        Ls = {len(r.prompt) for r in wave}
        if len(Ls) != 1:
            raise RuntimeError(
                f"wave mixes prompt lengths {sorted(Ls)} — waves are length-bucketed")
        toks = torch.as_tensor(np.stack([r.prompt for r in wave]).astype(np.int32), device=dev)
        cache = transformer.init_cache(cfg, B, scfg.max_len, device=dev)
        logits, cache = transformer.prefill(cfg, self.params, {"tokens": toks}, cache)
        self.n_waves += 1

        active = np.ones(B, bool)
        budget = np.array([r.max_new_tokens for r in wave])
        n_emitted = np.zeros(B, int)
        t0 = None
        while active.any():
            nxt = self._sample(logits)
            if t0 is not None:
                self.decode_step_s.append(time.perf_counter() - t0)
            for i, r in enumerate(wave):
                if not active[i]:
                    continue
                t = int(nxt[i])
                r.output.append(t)
                n_emitted[i] += 1
                if (r.eos_id is not None and t == r.eos_id) or n_emitted[i] >= budget[i]:
                    active[i] = False
                    r.done = True
            if not active.any():
                break
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(
                cfg, self.params, torch.as_tensor(nxt[:, None], device=dev), cache)
            self.n_decode_steps += 1

    # -- public ----------------------------------------------------------------
    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests in submit order."""
        buckets: dict[int, list[Request]] = {}
        for r in self.queue:
            buckets.setdefault(len(r.prompt), []).append(r)
        self.queue = []
        done: list[Request] = []
        for _, reqs in sorted(buckets.items()):
            for lo in range(0, len(reqs), self.scfg.max_batch):
                wave = reqs[lo:lo + self.scfg.max_batch]
                self._run_wave(wave)
                done.extend(wave)
        done.sort(key=lambda r: r._order)
        return done


class ContinuousEngine(_GraphEngine):
    """Continuous-batching engine driven by Graphi executables.

    Construction captures the batched decode step and *calibrates* it
    (``Executable.calibrate`` times every node on the decode shapes, the
    paper's first-iterations profiling); the configuration search picks
    ``n_executors x team_size`` from those measured costs, optionally
    bounded by ``max_executors``.  Prefill graphs are captured per prompt
    *bucket* on demand (prompts are right-padded to the next power of two
    and masked with ``valid_len``; exact length for MoE archs, whose
    capacity routing couples the positions of a prompt, and for Mamba and
    RG-LRU archs, whose state a pad token would enter), pinned to the same
    config, and run on the same step lease as the decode — so an admission
    prefill runs *concurrently* with the in-flight decode step.

    The decode graph is fixed — one batch shape, replayed once per token —
    so steady-state steps execute it through a compiled
    :class:`~repro_torch.core.static_host.StaticHostPlan`
    (``decode_host_mode="static"``).  Steps with admission prefills in
    flight fall back to the dynamic scheduler, which interleaves per op with
    the concurrent prefills; ``decode_host_mode="dynamic"`` uses it
    everywhere.

    Protocol per :meth:`step`:

    1. **admit** — pending requests claim free slots; their prefills run on
       the lease while the decode step for currently-active slots executes;
    2. **install** — each prefilled request's K/V lands in its slot
       (:func:`transformer.cache_insert_slot`), its first token is sampled
       from the prefill logits;
    3. **retire** — EOS/budget frees the slot immediately
       (:func:`transformer.cache_evict_slot`); the next step's admission
       fills it.

    Idle slots decode a pad token; their output is discarded and their
    cache rows are overwritten wholesale at the next insert, so active rows
    stay bit-identical to unbatched greedy decode.  The cache is updated
    out of place: each decode step and each insert writes a new cache.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        scfg: ServeConfig,
        *,
        device: str | torch.device = "cuda",
        rng_seed: int = 0,
        hw: HardwareModel = H100,
        max_executors: int | None = None,
        pool: ExecutorPool | None = None,
        runtime: Runtime | None = None,
        decode_host_mode: str = "static",
        schedule_search: str = "auto",
        step_deadline_s: float | None = None,
    ):
        from repro_torch import api

        refuse_frontend(cfg)
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.hw = hw
        # per-step deadline: every graph run inside one step() carries
        # deadline = step start + step_deadline_s, so a hung op raises
        # DeadlineExceeded instead of wedging the loop.  None = unbounded.
        self.step_deadline_s = step_deadline_s
        self._step_deadline: float | None = None
        self._gen = torch.Generator(device=dev).manual_seed(rng_seed)
        self.capacity = scfg.max_batch
        self.cache = transformer.init_cache(cfg, self.capacity, scfg.max_len, per_slot=True,
                                            device=dev)
        self._zero_sub_cache = transformer.init_cache(cfg, 1, scfg.max_len, per_slot=True,
                                                      device=dev)

        # executors come from the Runtime (leased per step) unless the caller
        # hands an explicit shared pool, which bypasses admission
        self.pool = pool
        self.runtime = runtime if runtime is not None else (
            None if pool is not None else default_runtime(dev))
        if self.runtime is not None and self.runtime.device.type != dev.type:
            raise ValueError(f"runtime runs on {self.runtime.device}, engine on {dev}")

        # -- decode graph: fixed shape, calibrated, static host plan --------
        i32 = {"dtype": torch.int32, "device": dev}
        tok_spec = torch.zeros((self.capacity, 1), **i32)
        # host seconds of each set-up phase (capture, calibration, warm-up)
        self.setup_s: dict[str, float] = {}
        t0 = time.perf_counter()
        self._decode_exe = api.compile(
            make_decode_step(cfg), params, self.cache, tok_spec,
            hw=hw, backend="host", jit_nodes=True, host_mode=decode_host_mode,
            pool=pool, runtime=self.runtime, schedule_search=schedule_search,
            name=f"serve_decode[{cfg.name}]",
        )
        self.schedule_search = schedule_search
        t1 = time.perf_counter()
        self.setup_s["decode_capture"] = t1 - t0
        self.decode_host_mode = self._decode_exe.host_mode
        self._plan_decode(lambda: (params, _zeros_like(self.cache),
                                   torch.full((self.capacity, 1), scfg.pad_id, **i32)),
                          max_executors)
        t2 = time.perf_counter()
        self.setup_s["decode_calibrate"] = t2 - t1
        # prefill graphs are keyed by *bucket*: prompts are right-padded to
        # the next power of two and masked with valid_len, so N distinct
        # lengths capture O(log N) graphs.  Bit-exact for dense
        # attention-only archs: padded tokens never enter a real token's
        # causal window and their entries are masked.  MoE capacity routing
        # couples the positions of a prompt (padding would change which
        # tokens are dropped), and Mamba / RG-LRU layers carry their state
        # through the padding, so those archs keep exact-length graphs.
        self._bucket_prefill = (
            not cfg.n_experts and all(k == "attn" for k in cfg.layer_kinds()))
        self._prefill_cap = transformer._attn_cache_len(cfg, scfg.max_len)
        self._prefill_exes: dict = {}

        self.slots: list[Request | None] = [None] * self.capacity
        self.pending: deque[Request] = deque()
        self.completed: list[Request] = []
        self._tokens = np.full((self.capacity, 1), scfg.pad_id, np.int32)
        self._n_submitted = 0
        # loop counters (benchmarks read these)
        self.n_steps = 0
        self.n_decode_steps = 0
        self.n_overlapped_prefills = 0
        self.decode_step_s: list[float] = []   # host wall time per decode step

        # warm every per-step code path against throwaway state
        t3 = time.perf_counter()
        warm = _zeros_like(self.cache)
        toks0 = self._dev(self._tokens)
        with self._step_pool() as wpool:
            logits, _ = self._run_exe(self._decode_exe, (params, warm, toks0), pool=wpool)
            if self._decode_exe.host_mode == "static":
                self._run_exe(self._decode_exe, (params, warm, toks0), pool=wpool,
                              host_mode="dynamic")
        logits.argmax(dim=-1).cpu()
        warm = transformer.cache_insert_slot(cfg, warm, self._zero_sub_cache, 0)
        warm = transformer.cache_evict_slot(cfg, warm, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_s["warm"] = time.perf_counter() - t3

    # -- submission ------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def stats(self) -> dict:
        return {"n_steps": self.n_steps, "n_decode_steps": self.n_decode_steps,
                "n_overlapped_prefills": self.n_overlapped_prefills,
                "n_prefill_graphs": len(self._prefill_exes)}

    def warmup(self, prompt_lens) -> None:
        """Capture and warm the prefill graphs for the given prompt lengths
        (deploy-time shape warming; admission then runs at steady state)."""
        with self._step_pool() as pool:
            for s in sorted(set(int(x) for x in prompt_lens)):
                self._prefill_exe(s, pool=pool)

    # -- internals -------------------------------------------------------------
    def _prefill_bucket(self, prompt_len: int) -> int:
        """Power-of-two length bucket, capped at the cache length (a ring
        cache shorter than the prompt leaves no room to pad: exact length);
        the exact length for MoE and recurrent archs."""
        if not self._bucket_prefill:
            return prompt_len
        b = 1 << max(0, prompt_len - 1).bit_length()
        b = min(b, self._prefill_cap)
        return b if b >= prompt_len else prompt_len

    def _prefill_batch(self, prompt) -> dict:
        S = len(prompt)
        if not self._bucket_prefill:
            return {"tokens": self._dev(np.asarray(prompt, np.int32)[None])}
        toks = np.full((1, self._prefill_bucket(S)), self.scfg.pad_id, np.int32)
        toks[0, :S] = prompt
        return {"tokens": self._dev(toks), "valid_len": self._dev(np.int32(S))}

    def _prefill_exe(self, prompt_len: int, pool=None):
        bucket = self._prefill_bucket(prompt_len)
        exe = self._prefill_exes.get(bucket)
        if exe is None:
            from repro_torch import api

            i32 = {"dtype": torch.int32, "device": self.device}
            spec = {"tokens": torch.zeros((1, bucket), **i32)}
            if self._bucket_prefill:
                spec["valid_len"] = torch.tensor(bucket, **i32)
            exe = api.compile(
                make_prefill_step(self.cfg), self.params, self._zero_sub_cache, spec,
                hw=self.hw, backend="host", pool=self.pool, runtime=self.runtime,
                jit_nodes=True, schedule_search=self.schedule_search,
                n_executors=self.n_executors, team_size=self._team_size,
                name=f"serve_prefill[{self.cfg.name},S={bucket}]",
            )
            # first-call warm-up, same reasoning as the decode graph
            logits, _ = self._run_exe(exe, (self.params, self._zero_sub_cache, spec),
                                      pool=pool)
            logits.argmax(dim=-1).cpu()
            self._prefill_exes[bucket] = exe
        return exe

    def _admit(self, req: Request, slot: int, pool=None):
        """Run the request's prefill graph on the step's executors."""
        exe = self._prefill_exe(len(req.prompt), pool=pool)
        logits, filled = self._run_exe(
            exe, (self.params, self._zero_sub_cache, self._prefill_batch(req.prompt)),
            pool=pool)
        return req, slot, logits, filled

    def _install(self, req: Request, slot: int, logits, filled) -> None:
        """Land a prefilled request in its slot and sample its first token."""
        self.cache = transformer.cache_insert_slot(self.cfg, self.cache, filled, slot)
        self.slots[slot] = req
        self._emit(slot, int(self._sample(logits)[0]))

    def _emit(self, slot: int, token: int) -> None:
        req = self.slots[slot]
        req.output.append(token)
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.completed.append(req)
            self.slots[slot] = None
            self.cache = transformer.cache_evict_slot(self.cfg, self.cache, slot)
            self._tokens[slot, 0] = self.scfg.pad_id
        else:
            self._tokens[slot, 0] = token

    def _decode_once(self, pool, *, overlapping_prefills: bool = False) -> None:
        exe = self._decode_exe
        host_mode = None
        if overlapping_prefills and exe.host_mode == "static":
            # a static plan's segments hold every executor of the step for
            # the whole decode, which would serialize the concurrent
            # admission prefills behind it; the dynamic scheduler interleaves
            # per op, so steps with prefills in flight fall back to it
            host_mode = "dynamic"
        t0 = time.perf_counter()
        logits, self.cache = self._run_exe(
            exe, (self.params, self.cache, self._dev(self._tokens)),
            pool=pool, host_mode=host_mode)
        self.n_decode_steps += 1
        nxt = self._sample(logits)
        self.decode_step_s.append(time.perf_counter() - t0)
        for i in range(self.capacity):
            if self.slots[i] is not None:
                self._emit(i, int(nxt[i]))

    # -- the loop --------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: admit into free slots, one decode step.

        The step leases the engine's executors once; admission prefills run
        concurrently with the decode step on those executors (from a worker
        thread) and their slots join the batch from the *next* step.
        Returns whether work remains.
        """
        self.n_steps += 1
        if self.step_deadline_s is not None:
            self._step_deadline = time.monotonic() + self.step_deadline_s
        free = [i for i, s in enumerate(self.slots) if s is None]
        admits: list[tuple[Request, int]] = []
        while self.pending and free:
            admits.append((self.pending.popleft(), free.pop(0)))
        decoding = any(s is not None for s in self.slots)

        with self._step_pool() as pool:
            # capture any new prompt bucket here, not on the worker thread
            for r, _ in admits:
                self._prefill_exe(len(r.prompt), pool=pool)
            if admits and decoding:
                box: dict = {}

                def prefill_worker() -> None:
                    if self.device.type == "cuda":
                        torch.cuda.set_device(self.device)
                    try:
                        box["res"] = [self._admit(r, s, pool=pool) for r, s in admits]
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        box["err"] = e

                th = threading.Thread(target=prefill_worker, name="serve-prefill")
                th.start()
                self._decode_once(pool, overlapping_prefills=True)
                th.join()
                if "err" in box:
                    raise box["err"]
                self.n_overlapped_prefills += len(admits)
                for item in box["res"]:
                    self._install(*item)
            elif admits:
                for r, s in admits:
                    self._install(*self._admit(r, s, pool=pool))
            elif decoding:
                self._decode_once(pool)
        self._step_deadline = None
        return self.has_work

    def run(self) -> list[Request]:
        """Drain pending + active requests; returns them in submit order."""
        while self.has_work:
            self.step()
        done = sorted(self.completed, key=lambda r: r._order)
        self.completed = []
        return done


def _zeros_like(cache: dict) -> dict:
    """A cache of the same structure with every tensor zeroed."""
    return {"len": torch.zeros_like(cache["len"]),
            "layers": [{kk: torch.zeros_like(t) for kk, t in lc.items()}
                       for lc in cache["layers"]]}
