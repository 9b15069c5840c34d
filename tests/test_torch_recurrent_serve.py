"""The recurrent archs (falcon-mamba-7b and recurrentgemma-2b, smoke size,
f32) through the port's slot and wave engines on the CPU, against the JAX
package on the same weights (``params_from_jax``).

Greedy streams must be *equal* to a reference that batches as each engine
does: the wave engine to the JAX ``ServeEngine.run()``; the per-slot engine
to a hand-driven loop over the reference's ``prefill`` (exact prompt
length: a pad token would enter the recurrent state), ``decode_step``,
``cache_insert_slot`` and ``cache_evict_slot`` that admits, decodes and
retires in the engine's order (the JAX ``ContinuousEngine`` cannot be
built on the installed JAX, ROADMAP C-1, so its functions are called
directly).  Idle slots decode the pad token and advance their state; the
insert overwrites it, so the streams are those of unbatched decoding too.
The paged engine, ``PagedConfig`` and the CLI's ``--paged`` refuse both
archs with the reference's message.
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

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]
MAX_LEN = 64
MAX_BATCH = 3
NEW_TOKENS = [7, 6, 8, 6, 5, 4]
REFUSAL = "paged serving requires a decoder-only attention-only rope arch"


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(1))
    if jcfg.tie_embeddings:
        # at its init scale recurrentgemma's tied, sqrt(d)-scaled embedding
        # outweighs the blocks and greedy decoding echoes the last token;
        # a smaller embedding (the same numbers in both packages) makes the
        # streams depend on the recurrence
        jp = {**jp, "embed": jp["embed"] / 8}
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def runtime():
    rt = Runtime(n_workers=2, device="cpu")
    yield rt
    rt.close()


def _prompts():
    rng = np.random.default_rng(11)
    # two pairs of equal lengths (shared wave buckets); 23 and 30 exceed
    # recurrentgemma's 16-token window, so its ring cache wraps
    return [rng.integers(1, 500, n).astype(np.int32) for n in (5, 23, 30, 5, 12, 23)]


def _serve(model, runtime, **kw):
    _, tcfg, _, tp = model
    if kw.get("continuous", True):
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


def _jax_unbatched(jcfg, jp):
    """Each request alone: prefill, then greedy decode at batch 1."""
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    out = []
    for p, n in zip(_prompts(), NEW_TOKENS):
        logits, cache = prefill(jp, jt.init_cache(jcfg, 1, MAX_LEN),
                                {"tokens": jnp.asarray(p[None])})
        toks = []
        while True:
            toks.append(int(_greedy(logits, jcfg.vocab_size)[0]))
            if len(toks) >= n:
                break
            logits, cache = decode(jp, cache, jnp.asarray([[toks[-1]]], jnp.int32))
        out.append(toks)
    return out


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_slot_engine_matches_hand_driven_reference(model, runtime, mode):
    jcfg, tcfg, jp, _ = model
    streams, eng = _serve(model, runtime, decode_host_mode=mode)
    assert isinstance(eng, ContinuousEngine) and eng.decode_host_mode == mode
    want = _jax_slot_loop(jcfg, jp)
    assert streams == want
    assert len({t for s in streams for t in s}) > 10      # not a repeat loop
    # a recurrent row does not see its neighbours: batching changes nothing
    assert want == _jax_unbatched(jcfg, jp)
    st = eng.stats()
    assert st["n_overlapped_prefills"] >= 1
    # exact-length prefill graphs: one per distinct prompt length
    assert not eng._bucket_prefill
    assert sorted(eng._prefill_exes) == [5, 12, 23, 30]
    scan = {"ssm": "ssm_scan", "rglru": "rglru_scan"}
    kinds = [n.kind for n in eng._decode_exe.graph.nodes]
    for kind in set(tcfg.layer_kinds()) - {"attn"}:
        assert kinds.count(scan[kind]) == tcfg.layer_kinds().count(kind)


def test_wave_engine_matches_reference(model):
    jcfg, _, jp, _ = model
    ref = JServeEngine(jcfg, jp, JServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN))
    for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS)):
        ref.submit(JRequest(i, p, max_new_tokens=n))
    want = [r.output for r in ref.run()]
    streams, eng = _serve(model, None, continuous=False)
    assert isinstance(eng, ServeEngine) and eng.stats()["n_waves"] == 4
    assert streams == want


@pytest.mark.parametrize("paged", [True, PagedConfig(page_size=8, prefill_chunk=16)])
def test_paged_engine_refuses_recurrent_archs(model, runtime, paged):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match=REFUSAL):
        serve_engine(tcfg, tp, ServeConfig(max_batch=2, max_len=MAX_LEN), paged=paged,
                     device="cpu", runtime=runtime)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", [[], ["--continuous"]])
def test_cli_serves_recurrent_archs(arch, mode, capsys):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8,19", "--max-new", "5", "--max-batch", "2"]
    assert serve.main(argv + mode) == 0
    out = capsys.readouterr().out
    name = "continuous" if mode else "wave"
    assert f"[{name}] served 4 requests, 20 tokens" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_refuses_paged_recurrent_archs(arch):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=REFUSAL):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--paged"])
