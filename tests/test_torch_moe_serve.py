"""The MoE archs (granite-moe-1b-a400m and olmoe-1b-7b, smoke size, f32)
through the port's model functions and its three engines on the CPU,
against the JAX package on the same weights (``params_from_jax``).

Model functions: ``prefill``, ``decode_step``, ``paged_decode_step`` and
``paged_prefill_chunk`` against the reference's, jitted and called
directly (its capture, and so its slot and paged engines, fail on the
installed JAX).  Logits within 2e-5.

Engines: greedy streams must be *equal* to a reference driven the same
way.  Capacity routing couples every token of a call — a decode step's idle
rows (they decode the pad token) and a padded prefill chunk's padding
included — so each engine is held to a reference that batches exactly as
it does: the wave engine to the JAX ``ServeEngine.run()``; the slot engine
to a hand-driven loop over the reference's ``prefill`` (exact prompt
length), ``decode_step``, ``cache_insert_slot`` and ``cache_evict_slot``
that admits, decodes and retires in the engine's order; the paged engine to
a loop over the reference's paged functions that allocates pages, runs
chunks and decodes in the paged engine's order.
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import serve_engine
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.runtime import Runtime
from repro_torch.serve import ContinuousEngine, PagedConfig, Request, ServeConfig, ServeEngine

ARCHS = ["granite-moe-1b-a400m", "olmoe-1b-7b"]
TOL = 2e-5
MAX_LEN = 64
PS, CHUNK = 8, 16


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(1))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_params_keep_each_leafs_dtype(model):
    """The router is f32 inside a bf16 model, and stays so."""
    _, tcfg, _, _ = model
    jcfg = j_get_config(tcfg.name, smoke=True)
    jp = jt.init_params(jcfg, jax.random.key(0))
    tp = tt.params_from_jax(get_config(tcfg.name, smoke=True), jax.tree.map(np.asarray, jp),
                            device="cpu")
    mlp = tp["layers"][1]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert all(mlp[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))
    E, D, F = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    assert tuple(mlp["w_gate"].shape) == (E, D, F) and tuple(mlp["w_down"].shape) == (E, F, D)
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(jp["layers"]["mlp"]["router"][1]))
    own = tt.init_params(get_config(tcfg.name, smoke=True), 0, device="cpu")
    assert own["layers"][0]["mlp"]["router"].dtype == torch.float32
    assert own["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["slot", "shared"])
def test_prefill_matches_reference(model, form):
    jcfg, tcfg, jp, tp = model
    B = 1 if form == "slot" else 2
    toks = np.random.default_rng(3).integers(1, 500, (B, 13)).astype(np.int32)
    per_slot = form == "slot"
    jl, jc = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))(
        jp, jt.init_cache(jcfg, B, MAX_LEN, per_slot=per_slot), {"tokens": jnp.asarray(toks)})
    tl, tc = tt.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                        tt.init_cache(tcfg, B, MAX_LEN, per_slot=per_slot, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tt.cache_to_stacked(tc)["layers"]["k"], _np(jc["layers"]["k"]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("form", ["per_slot", "shared"])
def test_decode_steps_match_reference(model, form):
    """Every row's logits, idle row included: it routes with the others."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    B = 4
    jc = jax.tree.map(np.array, jt.init_cache(jcfg, B, MAX_LEN, per_slot=form == "per_slot"))
    lay = jc["layers"]
    for kk in ("k", "v"):
        lay[kk] = rng.standard_normal(lay[kk].shape).astype(np.float32)
    if form == "per_slot":
        lens = [5, 20, 13, 0]
        for b, n in enumerate(lens):
            lay["pos"][:, b, :n] = np.arange(n, dtype=np.int32)
        jc["len"] = np.asarray(lens, np.int32)
    else:
        lay["pos"][:, :13] = np.arange(13, dtype=np.int32)
        jc["len"] = np.asarray(13, np.int32)
    tc = tt.cache_from_jax(tcfg, jc, device="cpu")
    jc = jax.tree.map(jnp.asarray, jc)
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    for _ in range(3):
        tok = rng.integers(1, 500, (B, 1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tcfg, tp, torch.as_tensor(tok), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)


def _pages(jcfg, n_pages, seed):
    rng = np.random.default_rng(seed)
    jpg = jax.tree.map(np.array, jt.init_paged_cache(jcfg, 1, MAX_LEN, n_pages=n_pages,
                                                     page_size=PS)["pages"])
    for kk in ("k", "v"):
        jpg[kk] = rng.standard_normal(jpg[kk].shape).astype(np.float32)
    return jpg


def test_paged_decode_step_matches_reference(model):
    """Rows at mixed depths and an idle row (empty table, length 0): its
    attention is the mean of page 0's V, and it routes with the others."""
    jcfg, tcfg, jp, tp = model
    n_pt = MAX_LEN // PS
    jpg = _pages(jcfg, 24, seed=6)
    table = np.full((4, n_pt), -1, np.int32)
    table[0, :3], table[1, :1], table[2, :5] = [1, 2, 3], [9], [4, 5, 6, 7, 8]
    lens = np.asarray([20, 3, 36, 0], np.int32)
    tok = np.asarray([[5], [17], [300], [0]], np.int32)
    jl, jcache = jax.jit(lambda p, c, t: jt.paged_decode_step(jcfg, p, t, c, page_size=PS))(
        jp, {"len": jnp.asarray(lens), "table": jnp.asarray(table),
             "pages": jax.tree.map(jnp.asarray, jpg)}, jnp.asarray(tok))
    tcache = {"len": torch.as_tensor(lens), "table": torch.as_tensor(table),
              "pages": tt.pages_from_jax(tcfg, jpg, device="cpu")}
    tl, tcache = tt.paged_decode_step(tcfg, tp, torch.as_tensor(tok), tcache, page_size=PS)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tt.pages_to_stacked(tcache["pages"])["k"],
                               _np(jcache["pages"]["k"]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("start,valid", [(0, 16), (16, 11)])
def test_paged_prefill_chunk_matches_reference(model, start, valid):
    """A chunk over context pages, padded past ``valid``: the MoE FFN runs
    over the whole padded chunk, padding included, as the reference's."""
    jcfg, tcfg, jp, tp = model
    n_pt = MAX_LEN // PS
    jpg = _pages(jcfg, 12, seed=7)
    row = np.full((n_pt,), -1, np.int32)
    row[:5] = [3, 7, 1, 10, 4]
    toks = np.zeros((1, CHUNK), np.int32)
    toks[0, :valid] = np.random.default_rng(8).integers(1, 500, valid)
    jl, jk, jv = jax.jit(lambda p, pg, r, t, s, v: jt.paged_prefill_chunk(
        jcfg, p, t, pg, r, s, v, page_size=PS))(
        jp, jax.tree.map(jnp.asarray, jpg), jnp.asarray(row), jnp.asarray(toks),
        jnp.int32(start), jnp.int32(valid))
    tl, tk, tv = tt.paged_prefill_chunk(
        tcfg, tp, torch.as_tensor(toks), tt.pages_from_jax(tcfg, jpg, device="cpu"),
        torch.as_tensor(row), torch.tensor(start, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32), page_size=PS)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.stack([t.numpy() for t in tk]), _np(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.stack([t.numpy() for t in tv]), _np(jv), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

MAX_BATCH = 3
NEW_TOKENS = [7, 6, 8, 6, 5, 4]


def _prompts():
    rng = np.random.default_rng(11)
    # two pairs of equal lengths (shared wave buckets); lengths that are not
    # powers of two, so a bucketing engine would pad them
    return [rng.integers(1, 500, n).astype(np.int32) for n in (5, 23, 30, 5, 12, 23)]


@pytest.fixture(scope="module")
def runtime():
    rt = Runtime(n_workers=2, device="cpu")
    yield rt
    rt.close()


def _serve(model, runtime, **kw):
    _, tcfg, _, tp = model
    if kw.get("continuous", True) or kw.get("paged"):
        kw["runtime"] = runtime
    eng = serve_engine(tcfg, tp, ServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN),
                       device="cpu", **kw)
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        eng.submit(Request(i, p, max_new_tokens=n))
    done = eng.run()
    assert [r.request_id for r in done] == list(range(len(NEW_TOKENS)))
    assert all(r.done and len(r.output) == n for r, n in zip(done, NEW_TOKENS))
    assert all(0 <= t < tcfg.vocab_size for r in done for t in r.output)
    return [r.output for r in done], eng


def _greedy(logits, vocab) -> np.ndarray:
    return np.asarray(jnp.argmax(logits[:, :vocab], axis=-1))


def _jax_slot_loop(jcfg, jp):
    """The per-slot engine's protocol over the reference's functions: each
    step admits pending requests into the lowest free slots; when rows are
    decoding, the step's decode runs first (the admitted slots still idle,
    decoding the pad token) and the admissions land after it; a finished
    request's slot is evicted at once.  Prefill is at the exact prompt
    length."""
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    insert = jax.jit(lambda c, s, i: jt.cache_insert_slot(jcfg, c, s, i))
    evict = jax.jit(lambda c, i: jt.cache_evict_slot(jcfg, c, i))
    V = jcfg.vocab_size
    cache = jt.init_cache(jcfg, MAX_BATCH, MAX_LEN, per_slot=True)
    sub0 = jt.init_cache(jcfg, 1, MAX_LEN, per_slot=True)
    pending = deque(enumerate(zip(_prompts(), NEW_TOKENS)))
    slots: list = [None] * MAX_BATCH
    outs: dict[int, list[int]] = {}
    tokens = np.zeros((MAX_BATCH, 1), np.int32)

    def emit(i, t):
        nonlocal cache
        rid, n = slots[i]
        outs[rid].append(t)
        if len(outs[rid]) >= n:
            slots[i] = None
            cache = evict(cache, jnp.int32(i))
            tokens[i, 0] = 0
        else:
            tokens[i, 0] = t

    def install(i, rid, p, n):
        nonlocal cache
        logits, sub = prefill(jp, sub0, {"tokens": jnp.asarray(p[None])})
        cache = insert(cache, sub, jnp.int32(i))
        slots[i] = (rid, n)
        outs[rid] = []
        emit(i, int(_greedy(logits, V)[0]))

    while pending or any(s is not None for s in slots):
        free = [i for i, s in enumerate(slots) if s is None]
        admits = []
        while pending and free:
            admits.append((free.pop(0), *pending.popleft()))
        if any(s is not None for s in slots):
            active = [i for i, s in enumerate(slots) if s is not None]
            logits, cache = decode(jp, cache, jnp.asarray(tokens))
            nxt = _greedy(logits, V)
            for i in active:
                emit(i, int(nxt[i]))
        for i, rid, (p, n) in admits:
            install(i, rid, p, n)
    return [outs[i] for i in range(len(NEW_TOKENS))]


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_slot_engine_matches_hand_driven_reference(model, runtime, mode):
    jcfg, _, jp, _ = model
    streams, eng = _serve(model, runtime, decode_host_mode=mode)
    assert isinstance(eng, ContinuousEngine) and eng.decode_host_mode == mode
    assert streams == _jax_slot_loop(jcfg, jp)
    assert len({t for s in streams for t in s}) > 10      # not a repeat loop
    st = eng.stats()
    assert st["n_overlapped_prefills"] >= 1
    # exact-length prefill graphs: one per distinct prompt length (the
    # dense archs keep power-of-two buckets: test_torch_slot_serve)
    assert st["n_prefill_graphs"] == len({len(p) for p in _prompts()}) == 4
    assert sorted(eng._prefill_exes) == [5, 12, 23, 30]


def test_wave_engine_matches_reference(model):
    jcfg, _, jp, _ = model
    ref = JServeEngine(jcfg, jp, JServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN))
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        ref.submit(JRequest(i, p, max_new_tokens=n))
    want = [r.output for r in ref.run()]
    streams, eng = _serve(model, None, continuous=False)
    assert isinstance(eng, ServeEngine) and eng.stats()["n_waves"] == 4
    assert streams == want


def _jax_paged_loop(jcfg, jp, n_pages):
    """The paged engine's protocol over the reference's paged functions,
    without prefix sharing: per step, admit into the lowest free slots,
    allocate each prefill's chunk pages (lowest free page first) and each
    decoding row's next page at a page boundary, run one chunk per prefill
    against the pre-decode pools and one decode step over every slot (idle
    and prefilling rows with an empty table, length 0 and the pad token),
    then insert the chunks' K/V and activate finished prefills."""
    n_pt = MAX_LEN // PS
    V = jcfg.vocab_size
    chunk = jax.jit(lambda p, pg, tr, t, s, v: jt.paged_prefill_chunk(
        jcfg, p, t, pg, tr, s, v, page_size=PS))
    insert = jax.jit(lambda pg, tr, s, v, kc, vc: jt.paged_insert_chunk(
        jcfg, pg, tr, s, v, kc, vc, page_size=PS))
    decode = jax.jit(lambda p, c, t: jt.paged_decode_step(jcfg, p, t, c, page_size=PS))
    pages = jt.init_paged_cache(jcfg, MAX_BATCH, MAX_LEN, n_pages=n_pages,
                                page_size=PS)["pages"]
    free_pages = deque(range(n_pages))
    table = np.full((MAX_BATCH, n_pt), -1, np.int32)
    lens = np.zeros(MAX_BATCH, np.int32)
    tokens = np.zeros((MAX_BATCH, 1), np.int32)
    slots: list = [None] * MAX_BATCH
    prefills: dict[int, list] = {}                 # slot -> [rid, n, prompt, pos]
    pending = deque(enumerate(zip(_prompts(), NEW_TOKENS)))
    outs: dict[int, list[int]] = {}

    def emit(i, t):
        rid, n = slots[i]
        outs[rid].append(t)
        if len(outs[rid]) >= n:
            slots[i] = None
            free_pages.extend(int(p) for p in table[i] if p >= 0)
            table[i] = -1
            lens[i] = 0
            tokens[i, 0] = 0
        else:
            tokens[i, 0] = t

    while pending or prefills or any(s is not None for s in slots):
        free = [i for i in range(MAX_BATCH) if slots[i] is None and i not in prefills]
        while pending and free:
            rid, (p, n) = pending.popleft()
            prefills[free.pop(0)] = [rid, n, p, 0]
        for slot, (_, _, p, pos) in prefills.items():
            T = min(CHUNK, len(p) - pos)
            for j in range(pos // PS, (pos + T - 1) // PS + 1):
                if table[slot, j] < 0:
                    table[slot, j] = free_pages.popleft()
        for i in range(MAX_BATCH):
            if slots[i] is not None and lens[i] % PS == 0 and table[i, lens[i] // PS] < 0:
                table[i, lens[i] // PS] = free_pages.popleft()
        results = []
        for slot, (_, _, p, pos) in prefills.items():
            T = min(CHUNK, len(p) - pos)
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :T] = p[pos:pos + T]
            results.append((slot, pos, T, chunk(jp, pages, jnp.asarray(table[slot]),
                                                jnp.asarray(toks), jnp.int32(pos),
                                                jnp.int32(T))))
        if any(s is not None for s in slots):
            live = [i for i in range(MAX_BATCH) if slots[i] is not None]
            tbl, ln = table.copy(), lens.copy()
            for i in range(MAX_BATCH):
                if slots[i] is None:
                    tbl[i], ln[i] = -1, 0
            logits, out = decode(jp, {"len": jnp.asarray(ln), "table": jnp.asarray(tbl),
                                      "pages": pages}, jnp.asarray(tokens))
            pages = out["pages"]
            nxt = _greedy(logits, V)
            for i in live:
                lens[i] += 1
                emit(i, int(nxt[i]))
        for slot, pos, T, (logits, kc, vc) in results:
            pages = insert(pages, jnp.asarray(table[slot]), jnp.int32(pos), jnp.int32(T), kc, vc)
            task = prefills[slot]
            task[3] = pos + T
            if task[3] >= len(task[2]):
                rid, n, p, _ = prefills.pop(slot)
                lens[slot] = len(p)
                slots[slot] = (rid, n)
                outs[rid] = []
                emit(slot, int(_greedy(logits, V)[0]))
    return [outs[i] for i in range(len(NEW_TOKENS))]


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_paged_engine_matches_hand_driven_reference(model, runtime, mode):
    jcfg, _, jp, _ = model
    n_pages = MAX_BATCH * (MAX_LEN // PS)
    streams, eng = _serve(model, runtime, decode_host_mode=mode, paged=PagedConfig(
        page_size=PS, prefill_chunk=CHUNK, share_prefix=False, n_pages=n_pages))
    assert eng.decode_host_mode == mode
    assert streams == _jax_paged_loop(jcfg, jp, n_pages)
    st = eng.stats()
    assert st["n_chunks"] >= 8 and st["n_overlapped_chunks"] >= 1
    assert st["n_evictions"] == 0 and st["n_shared_pages"] == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", [[], ["--continuous"],
                                  ["--paged", "--page-size", "8", "--prefill-chunk", "8"]])
def test_cli_serves_moe_archs(arch, mode, capsys):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8,19", "--max-new", "5", "--max-batch", "2"]
    assert serve.main(argv + mode) == 0
    out = capsys.readouterr().out
    name = "paged" if "--paged" in mode else "continuous" if mode else "wave"
    assert f"[{name}] served 4 requests, 20 tokens" in out
