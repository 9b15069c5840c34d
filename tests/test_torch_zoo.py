"""The zoo's other dense decoders in the port — yi-9b, h2o-danube3-4b (a
sliding window; at full width 32 / 8 heads of 120), command-r-plus-104b
(the parallel attention + FFN block) and an h2o smoke at its real head dim
120 (d_model 240, 2 / 1 heads) — against the JAX package, on the same
weights (``params_from_jax``) and the same numpy inputs.

Covers the configs and their lookup, ``prefill`` / ``decode_step`` over a
per-slot cache, ``paged_prefill_chunk`` / ``paged_decode_step``, the
training loss and every gradient against ``jax.grad`` (remat on and off),
the loss + gradient graph run three ways on the CPU runtime, the greedy
streams of the port's slot, wave and paged engines against the JAX wave
``ServeEngine.run()``, and the captured command-r decode graph, whose
attention and FFN branches of a layer must not reach each other.

f32 at the smoke size within 2e-5 (the two frameworks sum in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import transformer as jt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import serve_engine
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.capture import capture
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tt
from repro_torch.runtime import Runtime
from repro_torch.serve import PagedConfig, Request, ServeConfig
from repro_torch.serve.step import make_decode_step, make_paged_decode_step
from repro_torch.train.step import compile_lm_loss, lm_loss_fn, value_and_grad
from torch_graph_paths import descendants, parallel_branches

TOL = 2e-5
NAMES = ("yi-9b", "h2o-danube3-4b", "command-r-plus-104b")
# id -> (arch, smoke overrides)
ARCHS = {"yi": ("yi-9b", {}),
         "h2o": ("h2o-danube3-4b", {}),
         "command_r": ("command-r-plus-104b", {}),
         "h2o_hd120": ("h2o-danube3-4b", {"d_model": 240, "n_heads": 2, "n_kv_heads": 1})}
MAX_LEN, PS, CHUNK = 64, 8, 16


def _setup(key, seed=0, loud=False):
    arch, kw = ARCHS[key]
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32, **kw)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32, **kw)
    jp = jt.init_params(jcfg, jax.random.key(seed))
    if loud:
        # at init the embedding dominates the residual and greedy decode
        # repeats the last token; louder block outputs make the streams
        # depend on the attention, the FFN and the cache
        jp["layers"]["attn"]["wo"] = jp["layers"]["attn"]["wo"] * 16.0
        jp["layers"]["mlp"]["w_down"] = jp["layers"]["mlp"]["w_down"] * 16.0
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(name, smoke):
    got = dataclasses.asdict(get_config(name, smoke=smoke))
    want = dataclasses.asdict(j_get_config(name, smoke=smoke))
    assert got.pop("dtype") == torch.bfloat16
    assert str(want.pop("dtype")) == "<class 'jax.numpy.bfloat16'>"
    # the port's own fields (latent attention, shared experts, sigmoid
    # routing, a held share) keep their defaults here
    defaults = {f.name: f.default for f in dataclasses.fields(get_config(name))}
    for key in got.keys() - want.keys():
        assert got.pop(key) == defaults[key], key
    assert got == want


def test_get_config_takes_the_module_keys():
    assert {"yi_9b", "h2o_danube3_4b", "command_r_plus_104b"} <= set(list_archs())
    cfg = get_config("h2o-danube3-4b")
    assert (cfg.name, cfg.resolved_head_dim, cfg.sliding_window) == ("h2o-danube-3-4b", 120,
                                                                     4096)
    # the config's own name names no module: look configs up by module key
    with pytest.raises(KeyError, match="not ported"):
        get_config(cfg.name)
    assert get_config("command-r-plus-104b").parallel_block
    assert round(get_config("h2o-danube3-4b").n_params() / 1e9, 2) == 3.96


@pytest.mark.parametrize("name", NAMES)
def test_check_trainable_admits_the_three(name):
    tt.check_trainable(get_config(name))
    tt.check_trainable(get_config(name, smoke=True))


# -- model functions -------------------------------------------------------------

@pytest.mark.parametrize("key", list(ARCHS))
def test_prefill_and_decode_match_reference(key):
    """A right-padded per-slot prefill (16 tokens, 11 real: past the h2o
    smoke's 16-token window once decoded), then three decode steps of a
    3-row per-slot cache (one row wrapped, one idle)."""
    jcfg, tcfg, jp, tp = _setup(key)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jcfg.vocab_size, (1, 16)).astype(np.int32)
    jsub = jt.init_cache(jcfg, 1, MAX_LEN, per_slot=True)
    tsub = tt.init_cache(tcfg, 1, MAX_LEN, per_slot=True, device="cpu")
    jl, jsub = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))(
        jp, jsub, {"tokens": jnp.asarray(toks), "valid_len": jnp.int32(11)})
    tl, tsub = tt.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks),
                                     "valid_len": torch.tensor(11, dtype=torch.int32)}, tsub)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
    js = tt.cache_to_stacked(tsub)
    for kk in ("k", "v"):
        np.testing.assert_allclose(js["layers"][kk], _np(jsub["layers"][kk]), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(js["layers"]["pos"], np.asarray(jsub["layers"]["pos"]))

    B, lens = 3, [5, 40, 0]
    jc = jax.tree.map(np.asarray, jt.init_cache(jcfg, B, MAX_LEN, per_slot=True))
    lay = jc["layers"]
    for kk in ("k", "v"):
        lay[kk] = rng.standard_normal(lay[kk].shape).astype(np.float32)
    C = lay["pos"].shape[-1]
    pos = np.full((B, C), -1, np.int32)
    for b, n in enumerate(lens):
        p = np.arange(max(0, n - C), n, dtype=np.int32)
        pos[b, p % C] = p
    lay["pos"] = np.broadcast_to(pos, lay["pos"].shape).copy()
    jc["len"] = np.asarray(lens, np.int32)
    tc = tt.cache_from_jax(tcfg, jc, device="cpu")
    jc = jax.tree.map(jnp.asarray, jc)
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    for _ in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tcfg, tp, torch.as_tensor(tok), tc)
        np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("key", list(ARCHS))
def test_paged_chunks_and_decode_match_reference(key):
    """A 19-token prompt in two 16-token chunks and a 9-token one into
    mapped pages, then three paged decode steps (a third row idle)."""
    jcfg, tcfg, jp, tp = _setup(key)
    n_pt, n_pages, B = MAX_LEN // PS, 24, 3
    chunk = jax.jit(lambda p, pg, tr, t, s, v: jt.paged_prefill_chunk(
        jcfg, p, t, pg, tr, s, v, page_size=PS))
    insert = jax.jit(lambda pg, tr, s, v, kc, vc: jt.paged_insert_chunk(
        jcfg, pg, tr, s, v, kc, vc, page_size=PS))
    decode = jax.jit(lambda p, c, t: jt.paged_decode_step(jcfg, p, t, c, page_size=PS))
    jpages = jt.init_paged_cache(jcfg, B, MAX_LEN, n_pages=n_pages, page_size=PS)["pages"]
    tpages = tt.init_paged_cache(tcfg, B, MAX_LEN, n_pages=n_pages, page_size=PS,
                                 device="cpu")["pages"]
    table = np.full((B, n_pt), -1, np.int32)
    table[0, :3], table[1, :2] = [5, 7, 2], [11, 3]
    lens = np.zeros(B, np.int32)
    rng = np.random.default_rng(2)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    for row, n in ((0, 19), (1, 9)):
        toks = rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
        for start in range(0, n, CHUNK):
            valid = min(CHUNK, n - start)
            c = np.zeros((1, CHUNK), np.int32)
            c[0, :valid] = toks[start:start + valid]
            jl, jk, jv = chunk(jp, jpages, jnp.asarray(table[row]), jnp.asarray(c),
                               jnp.int32(start), jnp.int32(valid))
            tl, tk, tv = tt.paged_prefill_chunk(tcfg, tp, i32(c), tpages, i32(table[row]),
                                                i32(start), i32(valid), page_size=PS)
            np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
            jpages = insert(jpages, jnp.asarray(table[row]), jnp.int32(start),
                            jnp.int32(valid), jk, jv)
            tpages = tt.paged_insert_chunk(tcfg, tpages, table[row], start, valid, tk, tv,
                                           page_size=PS)
        lens[row] = n
    tokens = np.array([[3], [5], [0]], np.int32)
    for _ in range(3):
        jl, jcache = decode(jp, {"len": jnp.asarray(lens), "table": jnp.asarray(table),
                                 "pages": jpages}, jnp.asarray(tokens))
        tl, tcache = tt.paged_decode_step(tcfg, tp, i32(tokens), {
            "len": i32(lens), "table": i32(table), "pages": tpages}, page_size=PS)
        np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], atol=TOL, rtol=TOL)
        jpages, tpages = jcache["pages"], tcache["pages"]
        tokens = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        tokens[2] = 0
        lens[:2] += 1


def _by_path(jtree, ttree):
    """(name, port leaf, reference leaf) for every leaf; the reference's
    stacked [L, ...] layers against the port's per-layer list."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers":
            for i in range(np.asarray(leaf).shape[0]):
                t = ttree["layers"][i]
                for kk in keys[1:]:
                    t = t[kk]
                out.append((f"layers/{i}/{keys[1:]}", t, np.asarray(leaf)[i]))
        else:
            t = ttree
            for kk in keys:
                t = t[kk]
            out.append((str(keys), t, np.asarray(leaf)))
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("key", list(ARCHS))
def test_loss_and_grads_match_reference(key, remat):
    """The LM loss and every gradient against ``jax.grad`` — command-r's
    unused ``ln2`` included, zero in both."""
    jcfg, tcfg, jp, tp = _setup(key, seed=3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 25)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1
    nb = {"tokens": toks[:, :24].copy(), "labels": labels}
    (jl, _), jg = jax.value_and_grad(
        lambda p: japi.lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in nb.items()},
                               remat=remat), has_aux=True)(jp)
    (tl, _), tg = value_and_grad(lambda p, b: tapi.lm_loss(tcfg, p, b, remat=remat),
                                 has_aux=True, unread=tt.unread_params(tcfg))(
        tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(tl.item(), float(jl), atol=TOL, rtol=TOL)
    pairs = _by_path(jg, tg)
    assert len(pairs) == len(pytree.tree_leaves(tg))
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)
    if tcfg.parallel_block:
        assert all(not lp["ln2"].any() for lp in tg["layers"])


def test_value_and_grad_zeros_only_the_declared_unread_leaves():
    """A leaf the loss does not read gets a zero gradient when its key path
    is in ``unread`` (command-r's ``ln2``s, from ``unread_params``) and
    raises otherwise; archs without a parallel block declare none."""
    tp = {"a": torch.ones(3), "b": torch.ones(2)}
    batch = {"x": torch.arange(3.0)}

    def loss(p, b):
        return (p["a"] * b["x"]).sum()

    with pytest.raises(RuntimeError):
        value_and_grad(loss)(tp, batch)
    with pytest.raises(RuntimeError, match=r"\['b'\]"):
        value_and_grad(loss, unread=frozenset({"['a']"}))(tp, batch)
    _, grads = value_and_grad(loss, unread=frozenset({"['b']"}))(tp, batch)
    assert torch.equal(grads["a"], batch["x"]) and torch.equal(grads["b"], torch.zeros(2))
    _, tcfg, _, _ = _setup("command_r")
    assert tt.unread_params(tcfg) == {f"['layers'][{i}]['ln2']" for i in range(tcfg.n_layers)}
    assert tt.unread_params(_setup("yi")[1]) == frozenset()


def test_parallel_block_loss_grad_graph_runs_like_eager():
    """``compile_lm_loss(grad=True)`` of the command-r smoke: static plan,
    dynamic scheduler and ``Graph.execute`` on the CPU runtime give eager
    autograd's loss and gradients bit for bit."""
    _, tcfg, _, _ = _setup("command_r")
    tp = tt.init_params(tcfg, 4, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :16].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    with Runtime(2, device="cpu") as rt:
        exe = compile_lm_loss(tcfg, ShapeSpec("t", 16, 2, "train"), backend="host", grad=True,
                              runtime=rt, device="cpu")
        assert [n.kind for n in exe.graph.nodes].count("attention") == 2 * tcfg.n_layers
        want = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg),
                                                 unread=tt.unread_params(tcfg))(tp, batch))
        inputs = exe.captured.bind((tp, batch))
        runs = [exe.captured.unflatten(exe.execute_host(inputs, host_mode=m).outputs)
                for m in ("static", "dynamic")]
        runs.append(exe.captured.unflatten(exe.graph.execute(inputs)))
    for run in runs:
        got = pytree.tree_leaves(run)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


# -- the parallel block in a captured graph ----------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_command_r_branches_share_no_path(paged):
    """Each layer's attention output projection and FFN down product: no
    path between them in command-r's captured decode graph (per-slot and
    paged), one from the first to the second in yi-9b's sequential block."""
    for key, parallel in (("command_r", True), ("yi", False)):
        _, tcfg, _, tp = _setup(key)
        tokens = torch.zeros((4, 1), dtype=torch.int32)
        if paged:
            cache = tt.init_paged_cache(tcfg, 4, MAX_LEN, n_pages=16, page_size=PS,
                                        device="cpu")
            cache = {**cache, "len": torch.as_tensor(cache["len"]),
                     "table": torch.as_tensor(cache["table"])}
            step = make_paged_decode_step(tcfg, PS)
        else:
            cache = tt.init_cache(tcfg, 4, MAX_LEN, per_slot=True, device="cpu")
            step = make_decode_step(tcfg)
        captured = capture(step, tp, cache, tokens)
        pairs = parallel_branches(captured, tp)
        assert len(pairs) == tcfg.n_layers
        for wo, down in pairs:
            assert wo not in descendants(captured.graph, down)
            assert (down in descendants(captured.graph, wo)) is not parallel


# -- engines -------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(11)
    shared = rng.integers(1, vocab, 19).astype(np.int32)
    return [rng.integers(1, vocab, 5).astype(np.int32),
            np.concatenate([shared, rng.integers(1, vocab, 4)]).astype(np.int32),
            rng.integers(1, vocab, 30).astype(np.int32),
            np.concatenate([shared[:19], [11, 12, 13, 14]]).astype(np.int32),
            rng.integers(1, vocab, 12).astype(np.int32)]


NEW_TOKENS = [7, 6, 8, 6, 5]


@pytest.mark.parametrize("key", list(ARCHS))
def test_engines_match_the_jax_wave_engine(key):
    """Greedy streams of the port's slot (static and dynamic decode plans),
    wave and paged (prefix sharing on) engines, each equal to the JAX wave
    ``ServeEngine.run()`` on the same weights."""
    jcfg, tcfg, jp, tp = _setup(key, loud=True)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JServeEngine(jcfg, jp, JServeConfig(max_batch=3, max_len=MAX_LEN))
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        jeng.submit(JRequest(i, p, max_new_tokens=n))
    want = [r.output for r in jeng.run()]
    assert len({t for s in want for t in s}) > 8              # not a repeat loop

    def serve(**kw):
        eng = serve_engine(tcfg, tp, ServeConfig(max_batch=3, max_len=MAX_LEN), device="cpu",
                           **kw)
        for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
            eng.submit(Request(i, p, max_new_tokens=n))
        done = eng.run()
        assert [r.request_id for r in done] == list(range(len(prompts)))
        return [r.output for r in done], eng

    with Runtime(n_workers=2, device="cpu") as rt:
        for mode in ("static", "dynamic"):
            assert serve(runtime=rt, decode_host_mode=mode)[0] == want
        assert serve(continuous=False)[0] == want
        streams, eng = serve(runtime=rt, paged=PagedConfig(page_size=PS, prefill_chunk=CHUNK))
        assert streams == want
        assert eng.stats()["n_shared_pages"] >= 2
