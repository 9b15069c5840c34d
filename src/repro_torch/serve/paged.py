"""Block-paged KV serving: a global page pool, prefix sharing, chunked prefill.

:class:`PagedEngine` keeps the KV cache **paged**
(``transformer.init_paged_cache``): each layer's K/V lives in a global pool
of ``n_pages`` physical pages of ``page_size`` tokens, and each request slot
owns a host-side *page table* mapping logical page indices to physical
pages.  Three things fall out:

* **Memory proportional to live tokens** — a slot holds
  ``ceil(len/page_size)`` pages instead of a full ``max_len`` stripe, so
  mixed-length workloads pack far more requests into the same bytes
  (``pool.peak_used`` measures it).
* **Prefix sharing** — :class:`PagePool` registers completed pages under a
  hash of the token prefix they encode.  A new request whose prompt starts
  with an already-cached prefix *maps the same physical pages* (refcounted,
  read-only) and prefills only the tail; a prompt diverging mid-page gets a
  **copy-on-write** clone of the best partially-matching page
  (``transformer.paged_copy_page``) and recomputes from the divergence
  point.  Pages whose refcount drops to zero are kept as *cold* prefix
  cache (LRU) and reclaimed on demand.
* **Chunked prefill** — prompts prefill in page-aligned chunks, one chunk
  per engine step, overlapped with the in-flight decode on the same
  :class:`~repro_torch.runtime.ExecutorLease`.  A long prompt therefore never
  monopolizes a step: decode latency for active slots — and
  admission-to-first-token for *other* pending prompts — stays bounded by
  the chunk size, not by the longest prompt in flight.  The chunk graph is
  read-only over the pools (``transformer.paged_prefill_chunk`` returns the
  chunk's K/V; the engine scatters it in afterwards), so it coexists with
  the decode step's page writes without aliasing.

Under **pool exhaustion** the allocator first reclaims cold (refcount-zero)
registered pages, oldest first; if the pool is still full the engine evicts
the *youngest* in-flight request (lowest priority under FCFS), frees its
pages, and requeues it at the front of the pending queue — its prompt
*plus everything it already emitted* are recomputed via chunked prefill on
re-admission, so its token stream continues exactly where it stopped
(greedy decoding is deterministic).

Decode and chunk-prefill graphs are captured via ``repro_torch.api.compile``:
profiler-chosen executor config, decode replayed through a compiled static
host plan on steady-state steps, dynamic scheduling on steps with chunks in
flight.  On a CUDA device the executors are streams and every layer's paged
attention runs on the hand-written kernel.  The engine runs on the card
unless it is built with ``device="cpu"``; the JAX package's engine is the
parity reference (tests/test_torch_serve.py).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import H100, HardwareModel
from repro_torch.core.engine import ExecutorPool
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.runtime import Runtime, default_runtime
from repro_torch.serve.engine import Request, ServeConfig, _GraphEngine
from repro_torch.serve.step import make_paged_decode_step, make_prefill_chunk_step

__all__ = ["PagedConfig", "PagePool", "PagedEngine", "PoolExhausted", "refuse_unpaged"]


def refuse_unpaged(cfg: ModelConfig) -> None:
    """Raise the reference's ``ValueError`` for an arch the paged cache does
    not take (Mamba and RG-LRU layers carry recurrent state, which has no
    paged analogue)."""
    if not transformer.paged_supported(cfg):
        raise ValueError(
            "paged serving requires a decoder-only attention-only rope "
            f"arch (got frontend={cfg.frontend!r}, "
            f"kinds={set(cfg.layer_kinds())})")


class PoolExhausted(RuntimeError):
    """No free or reclaimable-cold page left in the pool."""


@dataclass(frozen=True)
class PagedConfig:
    page_size: int = 16
    n_pages: int | None = None     # default: max_batch * ceil(max_len/page_size)
    prefill_chunk: int = 64        # tokens per admission chunk (rounded up to
                                   # a page multiple)
    share_prefix: bool = True


class PagePool:
    """Host-side physical page allocator with a token-prefix registry.

    A page is *registered* once the tokens it encodes are known (at prefill
    completion): full pages under ``sha1(prompt[:end])`` for exact
    whole-page matching, and every registered page additionally under its
    *base* hash ``sha1(prompt[:start])`` together with its token list, so a
    later prompt sharing the base but diverging mid-page can find the best
    partial match for copy-on-write.

    Refcounts track how many request slots map a page.  ``release`` of a
    registered page keeps it as **cold** prefix cache (LRU-ordered) rather
    than freeing it; ``alloc`` reclaims the coldest such page when the free
    list runs dry, and raises :class:`PoolExhausted` only when nothing is
    reclaimable — the engine then evicts a whole request.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: deque[int] = deque(range(n_pages))
        self.ref = np.zeros(n_pages, np.int64)
        self.full_map: dict[bytes, int] = {}     # full-prefix digest -> page
        self.by_base: dict[bytes, dict[int, tuple]] = {}
        self.meta: dict[int, tuple] = {}         # page -> (full_key, base_key)
        self.cold: OrderedDict[int, None] = OrderedDict()
        # peak *hot* pages — mapped by at least one live request; cold
        # refcount-zero prefix cache is reclaimable on demand and therefore
        # not memory pressure
        self.peak_used = 0
        self.n_cold_reclaims = 0

    def used(self) -> int:
        return self.n_pages - len(self.free)

    def hot(self) -> int:
        return self.used() - len(self.cold)

    def _note_usage(self) -> None:
        self.peak_used = max(self.peak_used, self.hot())

    @staticmethod
    def _digest(tokens) -> bytes:
        return hashlib.sha1(np.asarray(tokens, np.int32).tobytes()).digest()

    def alloc(self) -> int:
        """A fresh page with refcount 1; reclaims the LRU cold page when the
        free list is empty."""
        if not self.free and self.cold:
            pid, _ = self.cold.popitem(last=False)
            self._unregister(pid)
            self.free.append(pid)
            self.n_cold_reclaims += 1
        if not self.free:
            raise PoolExhausted(
                f"all {self.n_pages} pages mapped by live requests")
        pid = self.free.popleft()
        self.ref[pid] = 1
        self._note_usage()
        return pid

    def share(self, pid: int) -> None:
        """Map an already-resident page into one more slot (read-only)."""
        if self.ref[pid] == 0:
            self.cold.pop(pid, None)             # cold -> hot again
        self.ref[pid] += 1
        self._note_usage()

    def release(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] < 0:
            raise RuntimeError(f"page {pid} over-released")
        if self.ref[pid] == 0:
            if pid in self.meta:
                self.cold[pid] = None            # keep as cold prefix cache
            else:
                self.free.append(pid)

    def register(self, pid: int, tokens, start: int, ntok: int) -> None:
        """Publish ``pid`` as encoding ``tokens[start:start+ntok]`` of the
        prefix ``tokens[:start+ntok]`` (no-op if already published, or if an
        identical full page exists)."""
        if pid in self.meta:
            return
        base_key = self._digest(tokens[:start])
        full_key = None
        if ntok == self.page_size:
            full_key = self._digest(tokens[:start + ntok])
            if full_key in self.full_map:
                return                           # duplicate content
            self.full_map[full_key] = pid
        page_toks = tuple(int(t) for t in tokens[start:start + ntok])
        self.by_base.setdefault(base_key, {})[pid] = page_toks
        self.meta[pid] = (full_key, base_key)

    def _unregister(self, pid: int) -> None:
        full_key, base_key = self.meta.pop(pid)
        if full_key is not None and self.full_map.get(full_key) == pid:
            del self.full_map[full_key]
        grp = self.by_base.get(base_key)
        if grp is not None:
            grp.pop(pid, None)
            if not grp:
                del self.by_base[base_key]

    def match_prefix(self, tokens, limit: int):
        """Longest registered prefix of ``tokens[:limit]``.

        Returns ``(full_pages, partial)``: physical ids of whole-page
        matches, then the best partially-matching page past them as
        ``(pid, n_common)`` (or None) — the caller shares the former and
        copy-on-writes the latter.  ``limit`` caps how many positions may be
        reused (at least the last prompt token must be *computed* so its
        logits exist)."""
        ps = self.page_size
        full: list[int] = []
        pos = 0
        while pos + ps <= limit:
            pid = self.full_map.get(self._digest(tokens[:pos + ps]))
            if pid is None:
                break
            full.append(pid)
            pos += ps
        best = None
        for pid, ptoks in self.by_base.get(self._digest(tokens[:pos]), {}).items():
            n = 0
            for a, b in zip(ptoks[:limit - pos], tokens[pos:]):
                if int(a) != int(b):
                    break
                n += 1
            if n > 0 and (best is None or n > best[1]):
                best = (pid, n)
        return full, best


class _PrefillTask:
    """A request whose prompt (plus any previously emitted tokens, on
    re-admission after eviction) is being prefilled chunk by chunk."""

    __slots__ = ("req", "tokens", "pos", "total")

    def __init__(self, req: Request, tokens: np.ndarray, pos: int):
        self.req = req
        self.tokens = tokens
        self.pos = pos
        self.total = len(tokens)


class PagedEngine(_GraphEngine):
    """Continuous batching over a block-paged KV cache (module docstring).

    Protocol per :meth:`step`:

    1. **admit** — pending requests claim free slots; prefix-matching pages
       are shared/CoW'd into their tables and a chunked-prefill task starts;
    2. **allocate** — each in-flight chunk's pages, plus a fresh tail page
       for any decoding slot crossing a page boundary (evicting cold pages,
       then whole younger requests, on exhaustion);
    3. **run** — one decode step over active slots concurrently with one
       prefill chunk per in-flight task, on the step's executor lease;
    4. **install** — chunk K/V scatters into the pools; a finished prefill
       registers its pages for sharing, activates its slot, and samples its
       first token from the chunk logits;
    5. **retire** — EOS/budget releases the slot's pages (refcount-zero
       registered pages stay as cold prefix cache).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        scfg: ServeConfig,
        *,
        paged: PagedConfig | None = None,
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
        refuse_unpaged(cfg)
        from repro_torch import api

        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.pcfg = paged or PagedConfig()
        self.hw = hw
        # see ContinuousEngine: per-step graph-run deadline; None = unbounded.
        self.step_deadline_s = step_deadline_s
        self._step_deadline: float | None = None
        self._gen = torch.Generator(device=dev).manual_seed(rng_seed)
        self.capacity = scfg.max_batch
        ps = self.pcfg.page_size
        self.chunk = -(-max(ps, self.pcfg.prefill_chunk) // ps) * ps
        self.n_pt = -(-scfg.max_len // ps)
        n_pages = self.pcfg.n_pages or self.capacity * self.n_pt
        if n_pages < self.n_pt:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one max_len={scfg.max_len} "
                f"request ({self.n_pt} pages of {ps})")
        cache0 = transformer.init_paged_cache(
            cfg, self.capacity, scfg.max_len, n_pages=n_pages, page_size=ps, device=dev)
        self._pages = cache0["pages"]
        self._table = cache0["table"]            # np [B, n_pt], host-managed
        self._len = cache0["len"]                # np [B]
        self.page_pool = PagePool(n_pages, ps)
        hd = cfg.resolved_head_dim
        self.page_bytes = (2 * cfg.n_layers * ps * cfg.n_kv_heads * hd
                           * torch.empty((), dtype=cfg.dtype).element_size())

        self.pool = pool
        self.runtime = runtime if runtime is not None else (
            None if pool is not None else default_runtime(dev))
        if self.runtime is not None and self.runtime.device.type != dev.type:
            raise ValueError(f"runtime runs on {self.runtime.device}, engine on {dev}")

        # -- decode graph: fixed shape, calibrated, static host plan --------
        i32 = {"dtype": torch.int32, "device": dev}
        cache_spec = {"len": torch.zeros((self.capacity,), **i32),
                      "table": torch.full((self.capacity, self.n_pt), -1, **i32),
                      "pages": self._pages}
        tok_spec = torch.zeros((self.capacity, 1), **i32)
        # host seconds of each set-up phase (capture, calibration, warm-up)
        self.setup_s: dict[str, float] = {}
        t0 = time.perf_counter()
        # schedule_search="auto": a calibrated decode graph freezes the
        # simulator-searched winner (persisted per graph signature), not
        # necessarily bare CPF — token streams are unchanged (same ops, same
        # numerics; only placements move)
        self._decode_exe = api.compile(
            make_paged_decode_step(cfg, ps), params, cache_spec, tok_spec,
            hw=hw, backend="host", jit_nodes=True, host_mode=decode_host_mode,
            pool=pool, runtime=self.runtime, schedule_search=schedule_search,
            name=f"serve_paged_decode[{cfg.name}]",
        )
        self.schedule_search = schedule_search
        t1 = time.perf_counter()
        self.setup_s["decode_capture"] = t1 - t0
        self.decode_host_mode = self._decode_exe.host_mode
        self._plan_decode(lambda: (
            params,
            {"len": torch.zeros((self.capacity,), **i32),
             "table": torch.zeros((self.capacity, self.n_pt), **i32),
             "pages": [{k: torch.zeros_like(v) for k, v in pg.items()} for pg in self._pages]},
            torch.full((self.capacity, 1), scfg.pad_id, **i32)), max_executors)
        t2 = time.perf_counter()
        self.setup_s["decode_calibrate"] = t2 - t1

        # -- chunk-prefill graph: ONE shape for every prompt length ---------
        self._chunk_exe = api.compile(
            make_prefill_chunk_step(cfg, ps), params, self._pages,
            torch.full((self.n_pt,), -1, **i32),
            {"tokens": torch.zeros((1, self.chunk), **i32)},
            torch.tensor(0, **i32), torch.tensor(self.chunk, **i32),
            hw=hw, backend="host", jit_nodes=True,
            pool=pool, runtime=self.runtime, schedule_search=schedule_search,
            n_executors=self.n_executors, team_size=self._team_size,
            name=f"serve_paged_chunk[{cfg.name},T={self.chunk}]",
        )

        t3 = time.perf_counter()
        self.setup_s["chunk_capture"] = t3 - t2

        # host-side page maintenance (eager, on the caller's stream)
        self._insert_chunk = (
            lambda pages, row, start, valid, kc, vc:
            transformer.paged_insert_chunk(cfg, pages, row, start, valid,
                                           kc, vc, page_size=ps))
        self._copy_page = (
            lambda pages, src, dst:
            transformer.paged_copy_page(cfg, pages, src, dst))

        self.slots: list[Request | None] = [None] * self.capacity
        self.prefills: dict[int, _PrefillTask] = {}
        self.pending: deque[Request] = deque()
        self.completed: list[Request] = []
        self._tokens = np.full((self.capacity, 1), scfg.pad_id, np.int32)
        self._n_submitted = 0
        # loop counters (benchmarks read these)
        self.n_steps = 0
        self.n_decode_steps = 0
        self.n_chunks = 0
        self.n_overlapped_chunks = 0
        self.n_shared_pages = 0
        self.n_cow_copies = 0
        self.n_evictions = 0
        self.decode_step_s: list[float] = []   # host wall time per decode step

        # warm every per-step code path against throwaway state
        warm_pages = [{k: torch.zeros_like(v) for k, v in pg.items()}
                      for pg in self._pages]
        warm_cache = {"len": torch.zeros((self.capacity,), **i32),
                      "table": torch.full((self.capacity, self.n_pt), -1, **i32),
                      "pages": warm_pages}
        toks0 = self._dev(self._tokens)
        with self._step_pool() as wpool:
            logits, _ = self._run_exe(
                self._decode_exe, (params, warm_cache, toks0), pool=wpool)
            if self._decode_exe.host_mode == "static":
                self._run_exe(self._decode_exe, (params, warm_cache, toks0),
                              pool=wpool, host_mode="dynamic")
            _, kc, vc = self._run_exe(
                self._chunk_exe,
                (params, warm_pages, torch.full((self.n_pt,), -1, **i32),
                 {"tokens": torch.zeros((1, self.chunk), **i32)},
                 torch.tensor(0, **i32), torch.tensor(self.chunk, **i32)),
                pool=wpool)
        logits.argmax(dim=-1).cpu()
        warm_pages = self._insert_chunk(
            warm_pages, torch.full((self.n_pt,), -1, **i32), 0, self.chunk, kc, vc)
        warm_pages = self._copy_page(warm_pages, 0, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_s["warm"] = time.perf_counter() - t3

    # -- submission ------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return (bool(self.pending) or bool(self.prefills)
                or any(s is not None for s in self.slots))

    def stats(self) -> dict:
        return {
            "n_steps": self.n_steps,
            "n_decode_steps": self.n_decode_steps,
            "n_chunks": self.n_chunks,
            "n_overlapped_chunks": self.n_overlapped_chunks,
            "n_shared_pages": self.n_shared_pages,
            "n_cow_copies": self.n_cow_copies,
            "n_evictions": self.n_evictions,
            "n_cold_reclaims": self.page_pool.n_cold_reclaims,
            "peak_pages": self.page_pool.peak_used,
            "peak_kv_bytes": int(self.page_pool.peak_used * self.page_bytes),
        }

    # -- page accounting -------------------------------------------------------
    def _alloc_page(self, protect: frozenset | set) -> int:
        """A fresh physical page, evicting whole requests (youngest first,
        never one in ``protect``) when even cold reclaim cannot satisfy it."""
        while True:
            try:
                return self.page_pool.alloc()
            except PoolExhausted:
                if not self._evict_one(protect):
                    raise RuntimeError(
                        f"page pool exhausted ({self.page_pool.n_pages} pages)"
                        " with nothing evictable — pool misconfigured"
                    ) from None

    def _evict_one(self, protect) -> bool:
        cands = [(r._order, i) for i, r in enumerate(self.slots)
                 if r is not None and i not in protect]
        cands += [(t.req._order, i) for i, t in self.prefills.items()
                  if i not in protect]
        if not cands:
            return False
        _, victim = max(cands)                   # youngest request loses
        self._requeue(victim)
        self.n_evictions += 1
        return True

    def _requeue(self, slot: int) -> None:
        """Evict ``slot``'s request under memory pressure: free its pages and
        put it back at the *front* of the pending queue.  Its prompt plus
        already-emitted tokens are recomputed by chunked prefill on
        re-admission, so the output stream continues unchanged."""
        req = (self.slots[slot] if self.slots[slot] is not None
               else self.prefills[slot].req)
        self._release_slot(slot)
        self.slots[slot] = None
        self.prefills.pop(slot, None)
        self._tokens[slot, 0] = self.scfg.pad_id
        self.pending.appendleft(req)

    def _release_slot(self, slot: int) -> None:
        for pid in self._table[slot]:
            if pid >= 0:
                self.page_pool.release(int(pid))
        self._table[slot] = -1
        self._len[slot] = 0

    # -- admission -------------------------------------------------------------
    def _begin_prefill(self, req: Request, slot: int) -> None:
        tokens = np.asarray(req.prompt, np.int32)
        if req.output:                           # re-admission after eviction
            tokens = np.concatenate(
                [tokens, np.asarray(req.output, np.int32)])
        task = _PrefillTask(req, tokens, 0)
        # at least the final token must be computed (its logits seed
        # sampling), so reuse is capped one position short of the end
        limit = task.total - 1
        ps = self.pcfg.page_size
        if self.pcfg.share_prefix and limit > 0:
            full, partial = self.page_pool.match_prefix(tokens, limit)
            for j, pid in enumerate(full):
                self.page_pool.share(pid)
                self._table[slot, j] = pid
            task.pos = len(full) * ps
            self.n_shared_pages += len(full)
            if partial is not None:
                src, n_common = partial
                dst = self._alloc_page(protect={slot})
                self._pages = self._copy_page(self._pages, src, dst)
                self._table[slot, len(full)] = dst
                task.pos += n_common
                self.n_cow_copies += 1
        self.prefills[slot] = task

    def _alloc_chunk_pages(self, slot: int, task: _PrefillTask) -> None:
        ps = self.pcfg.page_size
        T = min(self.chunk, task.total - task.pos)
        for j in range(task.pos // ps, (task.pos + T - 1) // ps + 1):
            if self._table[slot, j] < 0:
                self._table[slot, j] = self._alloc_page(protect={slot})

    def _finish_prefill(self, slot: int, task: _PrefillTask, logits) -> None:
        del self.prefills[slot]
        self._len[slot] = task.total
        ps = self.pcfg.page_size
        if self.pcfg.share_prefix:
            for j in range(-(-task.total // ps)):
                pid = int(self._table[slot, j])
                if pid >= 0:
                    self.page_pool.register(
                        pid, task.tokens, j * ps,
                        min(ps, task.total - j * ps))
        self.slots[slot] = task.req
        self._emit(slot, int(self._sample(logits)[0]))

    # -- decode / emit ---------------------------------------------------------
    def _emit(self, slot: int, token: int) -> None:
        req = self.slots[slot]
        req.output.append(token)
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.completed.append(req)
            self.slots[slot] = None
            self._release_slot(slot)
            self._tokens[slot, 0] = self.scfg.pad_id
        else:
            self._tokens[slot, 0] = token

    def _decode_once(self, pool, *, overlapping: bool = False) -> None:
        # idle rows (free, or mid-prefill) decode against an empty table:
        # their pool writes redirect out of bounds and drop, their logits
        # are discarded
        tbl = self._table.copy()
        ln = self._len.copy()
        for i in range(self.capacity):
            if self.slots[i] is None:
                tbl[i] = -1
                ln[i] = 0
        t0 = time.perf_counter()
        cache = {"len": self._dev(ln), "table": self._dev(tbl), "pages": self._pages}
        host_mode = None
        if overlapping and self._decode_exe.host_mode == "static":
            # same reasoning as ContinuousEngine: a static plan's segments
            # would serialize the concurrent chunk prefills behind the
            # decode, so overlapped steps fall back to the dynamic scheduler
            host_mode = "dynamic"
        logits, out = self._run_exe(
            self._decode_exe, (self.params, cache, self._dev(self._tokens)),
            pool=pool, host_mode=host_mode)
        self._pages = out["pages"]
        self.n_decode_steps += 1
        nxt = self._sample(logits)
        self.decode_step_s.append(time.perf_counter() - t0)
        for i in range(self.capacity):
            if self.slots[i] is not None:
                self._len[i] += 1
                self._emit(i, int(nxt[i]))

    def _run_chunk(self, pages_in, slot: int, start: int, valid: int,
                   toks: np.ndarray, pool):
        return self._run_exe(
            self._chunk_exe,
            (self.params, pages_in, self._dev(self._table[slot]),
             {"tokens": self._dev(toks)},
             self._dev(np.int32(start)), self._dev(np.int32(valid))),
            pool=pool)

    # -- the loop --------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: admit, allocate pages, run one decode step
        concurrently with one prefill chunk per in-flight prompt, install
        chunk K/V, retire finished requests.  Returns whether work remains."""
        self.n_steps += 1
        if self.step_deadline_s is not None:
            self._step_deadline = time.monotonic() + self.step_deadline_s
        ps = self.pcfg.page_size

        # 1. admit pending requests into free slots (prefix share / CoW)
        free = [i for i in range(self.capacity)
                if self.slots[i] is None and i not in self.prefills]
        while self.pending and free:
            self._begin_prefill(self.pending.popleft(), free.pop(0))

        # 2. allocate this step's pages: chunk spans, then decode boundary
        # pages.  Allocation may evict requests (youngest first), so re-check
        # liveness at each use.
        for slot, task in list(self.prefills.items()):
            if slot in self.prefills:
                self._alloc_chunk_pages(slot, task)
        for i in range(self.capacity):
            if (self.slots[i] is not None and self._len[i] % ps == 0
                    and self._table[i, self._len[i] // ps] < 0):
                self._table[i, self._len[i] // ps] = self._alloc_page(
                    protect={i})

        # 3. run: one chunk per surviving prefill, overlapped with decode
        jobs = []
        for slot, task in self.prefills.items():
            T = min(self.chunk, task.total - task.pos)
            toks = np.full((1, self.chunk), self.scfg.pad_id, np.int32)
            toks[0, :T] = task.tokens[task.pos:task.pos + T]
            jobs.append((slot, task, task.pos, T, toks))
        decoding = any(s is not None for s in self.slots)
        # chunks read the pre-decode page snapshot: their context mask stops
        # strictly below `start`, so the decode step's concurrent tail writes
        # can never alias what a chunk reads
        pages_in = self._pages
        results = None
        with self._step_pool() as pool:
            if jobs and decoding:
                box: dict = {}

                def chunk_worker() -> None:
                    if self.device.type == "cuda":
                        torch.cuda.set_device(self.device)
                    try:
                        box["res"] = [
                            self._run_chunk(pages_in, s, p, t, tk, pool)
                            for s, _, p, t, tk in jobs]
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        box["err"] = e

                th = threading.Thread(target=chunk_worker,
                                      name="serve-paged-prefill")
                th.start()
                self._decode_once(pool, overlapping=True)
                th.join()
                if "err" in box:
                    raise box["err"]
                self.n_overlapped_chunks += len(jobs)
                results = box["res"]
            elif jobs:
                results = [self._run_chunk(pages_in, s, p, t, tk, pool)
                           for s, _, p, t, tk in jobs]
            elif decoding:
                self._decode_once(pool)

        # 4. install chunk K/V (disjoint from the decode step's writes) and
        # activate finished prefills
        if results:
            for (slot, task, start, T, _), (logits, kc, vc) in zip(jobs, results):
                self._pages = self._insert_chunk(
                    self._pages, self._table[slot], start, T, kc, vc)
                self.n_chunks += 1
                task.pos = start + T
                if task.pos >= task.total:
                    self._finish_prefill(slot, task, logits)
        self._step_deadline = None
        return self.has_work

    def run(self) -> list[Request]:
        """Drain pending + active requests; returns them in submit order."""
        while self.has_work:
            self.step()
        done = sorted(self.completed, key=lambda r: r._order)
        self.completed = []
        return done
