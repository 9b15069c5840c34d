"""The port's paged engine on the CPU against a greedy loop over the JAX
package's paged model functions (jitted and called directly: the
reference's capture, and so its engines, fail on the installed JAX).

f32 smoke config, same weights (``params_from_jax``).  Token streams must be
equal — to the reference loop, and to each other across static/dynamic
decode plans, prefix sharing on/off, and pool-exhaustion eviction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jt
from repro_torch.api import serve_engine
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.runtime import Runtime
from repro_torch.serve import PagedConfig, Request, ServeConfig

PS, CHUNK, MAX_BATCH, MAX_LEN = 8, 16, 3, 64


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 500, 19).astype(np.int32)
    return [
        rng.integers(1, 500, 5).astype(np.int32),
        np.concatenate([shared, rng.integers(1, 500, 4)]).astype(np.int32),
        rng.integers(1, 500, 30).astype(np.int32),
        # shares two full pages and part of the third with request 1
        np.concatenate([shared[:21 - 2], [11, 12]]).astype(np.int32),
        rng.integers(1, 500, 12).astype(np.int32),
    ]


NEW_TOKENS = [7, 6, 8, 6, 5]


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


def _reference_stream(jcfg, jp, prompt, n_new):
    """Greedy decode of one request through the reference's paged functions:
    its own pages 0..n_pt-1, chunked prefill, then batch-1 decode steps."""
    n_pt = MAX_LEN // PS
    cache = jt.init_paged_cache(jcfg, 1, MAX_LEN, n_pages=n_pt, page_size=PS)
    pages = cache["pages"]
    table = np.arange(n_pt, dtype=np.int32)
    chunk = jax.jit(lambda p, pg, tr, t, s, v: jt.paged_prefill_chunk(
        jcfg, p, t, pg, tr, s, v, page_size=PS))
    insert = jax.jit(lambda pg, tr, s, v, kc, vc: jt.paged_insert_chunk(
        jcfg, pg, tr, s, v, kc, vc, page_size=PS))
    decode = jax.jit(lambda p, c, t: jt.paged_decode_step(jcfg, p, t, c, page_size=PS))
    for start in range(0, len(prompt), CHUNK):
        valid = min(CHUNK, len(prompt) - start)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        logits, kc, vc = chunk(jp, pages, jnp.asarray(table), jnp.asarray(toks),
                               jnp.int32(start), jnp.int32(valid))
        pages = insert(pages, jnp.asarray(table), jnp.int32(start), jnp.int32(valid), kc, vc)
    out = [int(jnp.argmax(logits[0, :jcfg.vocab_size]))]
    length = len(prompt)
    while len(out) < n_new:
        logits, c = decode(jp, {"len": jnp.asarray([length], jnp.int32),
                                "table": jnp.asarray(table[None]), "pages": pages},
                           jnp.asarray([[out[-1]]], jnp.int32))
        pages = c["pages"]
        length += 1
        out.append(int(jnp.argmax(logits[0, :jcfg.vocab_size])))
    return out


@pytest.fixture(scope="module")
def reference_streams(setup):
    jcfg, _, jp, _, _ = setup
    return [_reference_stream(jcfg, jp, p, n) for p, n in zip(_prompts(), NEW_TOKENS)]


def _serve(setup, *, temperature=0.0, **kw):
    _, tcfg, _, tp, rt = setup
    pcfg = PagedConfig(page_size=PS, prefill_chunk=CHUNK,
                       share_prefix=kw.pop("share_prefix", True),
                       n_pages=kw.pop("n_pages", None))
    eng = serve_engine(tcfg, tp, ServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                                             temperature=temperature),
                       paged=pcfg, device="cpu", runtime=rt, **kw)
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        eng.submit(Request(i, p, max_new_tokens=n))
    done = eng.run()
    assert [r.request_id for r in done] == list(range(len(NEW_TOKENS)))
    assert all(r.done for r in done)
    return [r.output for r in done], eng


def test_engine_matches_reference_greedy_loop(setup, reference_streams):
    streams, eng = _serve(setup)
    assert streams == reference_streams
    assert len({t for s in streams for t in s}) > 10      # not a repeat loop
    st = eng.stats()
    assert st["n_shared_pages"] >= 2 and st["n_cow_copies"] >= 1
    assert st["n_overlapped_chunks"] >= 1


@pytest.mark.parametrize("variant", ["dynamic", "no_sharing", "eviction"])
def test_engine_variants_give_identical_streams(setup, reference_streams, variant):
    kw = {"dynamic": {"decode_host_mode": "dynamic"},
          "no_sharing": {"share_prefix": False},
          "eviction": {"n_pages": MAX_LEN // PS}}[variant]
    streams, eng = _serve(setup, **kw)
    assert streams == reference_streams
    if variant == "eviction":
        assert eng.stats()["n_evictions"] >= 1
    if variant == "no_sharing":
        assert eng.stats()["n_shared_pages"] == 0
    if variant == "dynamic":
        assert eng.decode_host_mode == "dynamic"


def test_temperature_sampling_stays_in_vocab_and_follows_the_seed(setup):
    a, _ = _serve(setup, temperature=1.0, rng_seed=3)
    b, _ = _serve(setup, temperature=1.0, rng_seed=3)
    assert a == b
    vocab = setup[1].vocab_size
    assert all(0 <= t < vocab for s in a for t in s)
