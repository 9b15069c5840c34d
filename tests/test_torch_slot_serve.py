"""The port's per-slot ``ContinuousEngine`` and wave ``ServeEngine`` on the
CPU against the JAX package: its wave ``ServeEngine.run()`` (which jits the
model functions and works on the installed JAX) and a hand-driven jitted
per-slot loop over its ``prefill`` / ``decode_step`` / ``cache_insert_slot``
/ ``cache_evict_slot`` (its ``ContinuousEngine`` cannot be built: its
capture is broken on the installed JAX).

f32 smoke config, same weights (``params_from_jax``).  Greedy token streams
must be equal — to both references, and across the engine's static and
dynamic decode plans.
"""
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
from repro_torch.serve import ContinuousEngine, Request, ServeConfig, ServeEngine

MAX_BATCH, MAX_LEN = 3, 64
NEW_TOKENS = [7, 6, 8, 6, 5, 4]


def _prompts():
    rng = np.random.default_rng(11)
    # two pairs of equal lengths (shared wave buckets), lengths that pad to
    # the next power of two in the slot engine's prefill buckets
    return [rng.integers(1, 500, n).astype(np.int32) for n in (5, 23, 30, 5, 12, 23)]


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("gemma-2b", smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(0))
    # at init the tied embedding dominates the residual and greedy decode
    # just repeats the last token; louder block outputs make the streams
    # depend on the attention and the cache
    jp["layers"]["attn"]["wo"] = jp["layers"]["attn"]["wo"] * 16.0
    jp["layers"]["mlp"]["w_down"] = jp["layers"]["mlp"]["w_down"] * 16.0
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rt = Runtime(n_workers=2, device="cpu")
    yield jcfg, tcfg, jp, tp, rt
    rt.close()


@pytest.fixture(scope="module")
def wave_reference(setup):
    jcfg, _, jp, _, _ = setup
    eng = JServeEngine(jcfg, jp, JServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN))
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        eng.submit(JRequest(i, p, max_new_tokens=n))
    return [r.output for r in eng.run()]


def _jax_slot_loop(jcfg, jp):
    """Greedy per-slot continuous batching driven by hand over the
    reference's jitted functions: admit into free slots (bucketed prefill
    with valid_len, insert), one batched decode step, evict on budget."""
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    insert = jax.jit(lambda c, s, i: jt.cache_insert_slot(jcfg, c, s, i))
    evict = jax.jit(lambda c, i: jt.cache_evict_slot(jcfg, c, i))
    cache = jt.init_cache(jcfg, MAX_BATCH, MAX_LEN, per_slot=True)
    sub0 = jt.init_cache(jcfg, 1, MAX_LEN, per_slot=True)
    pending = list(enumerate(zip(_prompts(), NEW_TOKENS)))
    slots: list = [None] * MAX_BATCH
    outs: dict[int, list[int]] = {}
    tokens = np.zeros((MAX_BATCH, 1), np.int32)

    def emit(i, t):
        rid, n = slots[i]
        outs[rid].append(t)
        tokens[i, 0] = t
        if len(outs[rid]) >= n:
            slots[i] = None
            tokens[i, 0] = 0
            return True
        return False

    while pending or any(slots):
        for i in range(MAX_BATCH):
            if slots[i] is None and pending:
                rid, (p, n) = pending.pop(0)
                bucket = 1 << max(0, len(p) - 1).bit_length()
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :len(p)] = p
                logits, sub = prefill(jp, sub0, {"tokens": jnp.asarray(toks),
                                                 "valid_len": jnp.int32(len(p))})
                cache = insert(cache, sub, jnp.int32(i))
                slots[i] = (rid, n)
                outs[rid] = []
                if emit(i, int(jnp.argmax(logits[0, :jcfg.vocab_size]))):
                    cache = evict(cache, jnp.int32(i))
        if not any(slots):
            continue
        logits, cache = decode(jp, cache, jnp.asarray(tokens))
        nxt = np.asarray(jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1))
        for i in range(MAX_BATCH):
            if slots[i] is not None and emit(i, int(nxt[i])):
                cache = evict(cache, jnp.int32(i))
    return [outs[i] for i in range(len(NEW_TOKENS))]


@pytest.fixture(scope="module")
def slot_reference(setup):
    jcfg, _, jp, _, _ = setup
    return _jax_slot_loop(jcfg, jp)


def _serve(setup, *, continuous=True, temperature=0.0, **kw):
    _, tcfg, _, tp, rt = setup
    if continuous:
        kw["runtime"] = rt
    eng = serve_engine(tcfg, tp, ServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                                             temperature=temperature),
                       continuous=continuous, device="cpu", **kw)
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        eng.submit(Request(i, p, max_new_tokens=n))
    done = eng.run()
    assert [r.request_id for r in done] == list(range(len(NEW_TOKENS)))
    assert all(r.done and len(r.output) == n for r, n in zip(done, NEW_TOKENS))
    return [r.output for r in done], eng


def test_references_agree(wave_reference, slot_reference):
    assert wave_reference == slot_reference
    assert len({t for s in wave_reference for t in s}) > 10     # not a repeat loop


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_continuous_engine_matches_references(setup, wave_reference, slot_reference, mode):
    streams, eng = _serve(setup, decode_host_mode=mode)
    assert isinstance(eng, ContinuousEngine) and eng.decode_host_mode == mode
    assert streams == slot_reference == wave_reference
    st = eng.stats()
    assert st["n_overlapped_prefills"] >= 1
    assert st["n_prefill_graphs"] == 3                  # buckets 8, 16 and 32
    assert len(eng.decode_step_s) == st["n_decode_steps"] > 0


def test_wave_engine_matches_references(setup, wave_reference):
    streams, eng = _serve(setup, continuous=False)
    assert isinstance(eng, ServeEngine)
    assert streams == wave_reference
    assert eng.stats()["n_waves"] == 4                  # lengths 5, 12, 23, 30


def test_slot_engine_refills_freed_slots_and_evicts(setup):
    _, eng = _serve(setup)
    assert all(s is None for s in eng.slots) and not eng.pending
    # every slot was evicted: positions cleared, lengths reset
    assert int(eng.cache["len"].abs().sum()) == 0
    assert all(bool((lc["pos"] == -1).all()) for lc in eng.cache["layers"])


@pytest.mark.parametrize("continuous", [True, False])
def test_temperature_sampling_stays_in_vocab_and_follows_the_seed(setup, continuous):
    a, _ = _serve(setup, continuous=continuous, temperature=1.0, rng_seed=3)
    b, _ = _serve(setup, continuous=continuous, temperature=1.0, rng_seed=3)
    assert a == b
    vocab = setup[1].vocab_size
    assert all(0 <= t < vocab for s in a for t in s)
