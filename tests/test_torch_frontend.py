"""The frontend archs in the port — whisper-medium (an encoder over frame
embeddings, cross-attention in every decoder layer, sinusoidal positions)
and llava-next-34b (image embeddings ahead of the text) — against the JAX
package, on the same weights (``params_from_jax``) and the same numpy
inputs.

Covers the configs, ``sinusoidal_positions`` and the single-position form
of the embedding, ``prefill`` (logits and the whole cache, ``enc``
included) and four ``decode_step`` s in both cache forms, greedy streams
of the serving steps against a jitted JAX loop, ``make_batch`` /
``input_specs``, the captured steps on the CPU runtime (static, dynamic
and sequential) against eager, the wave engine on llava (served as text,
as the reference serves it), the engines' refusals, the trainer's
admission of both archs (their training is held to the reference in
``test_torch_frontend_train.py``), and the plain B3 at ``causal=False`` with ``Sq != Skv`` against
``attention_ref``.

f32 at the smoke size within 2e-5 (the two frameworks sum in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import compile as rt_compile
from repro_torch.api import serve_engine
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve as serve_cli
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.runtime import Runtime
from repro_torch.serve import PagedConfig, Request, ServeConfig
from repro_torch.serve.step import make_decode_step, make_prefill_step, sample_tokens

TOL = 2e-5
ARCHS = ("whisper-medium", "llava-next-34b")
MAX_LEN = 48
B, S = 2, 7


def _setup(arch, seed=0, loud=False):
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(seed))
    if loud:
        # at init the embedding dominates the residual and greedy decode
        # repeats the last token; louder block outputs make the streams
        # depend on the attention (cross-attention too), the FFN and the cache
        for blk, w in (("attn", "wo"), ("xattn", "wo"), ("mlp", "w_down")):
            if blk in jp["layers"]:
                jp["layers"][blk][w] = jp["layers"][blk][w] * 16.0
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _frontend_inputs(cfg, rng, batch: int) -> dict:
    """The frontend stub's embeddings for a prompt batch, from numpy."""
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((batch, cfg.encoder_len, cfg.d_model))
                .astype(np.float32)}
    return {"image_embeds": rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model))
            .astype(np.float32)}


def _both(nb: dict):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()})


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
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


def test_frontend_archs_are_listed_and_sized():
    assert {"whisper_medium", "llava_next_34b"} <= set(list_archs())
    w = get_config("whisper-medium")
    assert (w.n_layers, w.n_encoder_layers, w.d_model, w.encoder_len, w.rope_theta) == (
        24, 24, 1024, 1500, 0.0)
    assert round(w.n_params() / 1e9, 2) == round(j_get_config("whisper-medium").n_params()
                                                 / 1e9, 2)
    llava = get_config("llava-next-34b")
    assert (llava.n_layers, llava.n_heads, llava.n_kv_heads, llava.n_image_tokens) == (
        60, 56, 8, 2880)


@pytest.mark.parametrize("kw", [{"frontend": "audio"}, {"frontend": "video"},
                                {"n_encoder_layers": 2, "cross_attention": True},
                                {"frontend": "audio", "n_encoder_layers": 2,
                                 "cross_attention": True, "parallel_block": True}])
def test_malformed_frontend_configs_are_refused(kw):
    """An audio frontend needs encoder layers and cross-attention in
    sequential attention blocks; neither comes without it."""
    cfg = get_config("gemma-2b", smoke=True).reduced(**kw)
    with pytest.raises(ValueError, match="frontends"):
        tt.init_params(cfg, 0, device="cpu")


# -- sinusoidal positions --------------------------------------------------------

@pytest.mark.parametrize("n, d", [(16, 64), (64, 1024), (5, 2), (3, 7)])
def test_sinusoidal_table_matches_reference(n, d):
    np.testing.assert_allclose(tlayers.sinusoidal_positions(n, d).numpy(),
                               np.asarray(jlayers.sinusoidal_positions(n, d)), atol=TOL,
                               rtol=TOL)


def test_sinusoidal_table_at_whisper_length():
    """At whisper's 1500 frame positions the two frameworks' f32 ``exp``
    may give a frequency one ulp apart, and position p turns that into an
    angle p ulps apart: the bound is one ulp (2^-23 relative) times the
    last position.  The frequencies themselves agree within one ulp."""
    n, d = 1500, 1024
    got = tlayers.sinusoidal_positions(n, d).numpy()
    want = np.asarray(jlayers.sinusoidal_positions(n, d))
    assert np.abs(got - want).max() <= (n - 1) * 2.0 ** -23
    np.testing.assert_allclose(got[1, :d // 2], want[1, :d // 2], rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("offset", [None, 0, 5, [3, 11]])
def test_embedding_positions_match_reference(offset):
    """whisper's ``_embed``: the table over the tokens at prefill, one
    position at decode from a scalar (the shared cache) or a ``[B]`` offset
    (per slot)."""
    jcfg, tcfg, jp, tp = _setup("whisper-medium")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (2, 1 if offset is not None else 9))
    toks = toks.astype(np.int32)
    jo = None if offset is None else jnp.asarray(offset, jnp.int32)
    to = None if offset is None else torch.tensor(offset, dtype=torch.int32)
    want = jt._embed(jcfg, jp, jnp.asarray(toks), pos_offset=jo)
    got = tt._embed(tcfg, tp, torch.from_numpy(toks), pos_offset=to)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


# -- model functions -------------------------------------------------------------

def _cache_equal(tc, jc):
    got = tt.cache_to_stacked(tc)
    assert set(got) == set(jc)
    np.testing.assert_array_equal(got["len"], np.asarray(jc["len"]))
    for kk in ("k", "v"):
        np.testing.assert_allclose(got["layers"][kk], _np(jc["layers"][kk]), atol=TOL,
                                   rtol=TOL, err_msg=kk)
    np.testing.assert_array_equal(got["layers"]["pos"], np.asarray(jc["layers"]["pos"]))
    if "enc" in jc:
        np.testing.assert_allclose(got["enc"], _np(jc["enc"]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, per_slot):
    """A prefill of B prompts with the frontend's embeddings (logits and
    the whole cache, ``enc`` included), then four decode steps (logits,
    then the whole cache again)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    nb = {"tokens": rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32),
          **_frontend_inputs(jcfg, rng, B)}
    jb, tb = _both(nb)
    jc = jt.init_cache(jcfg, B, MAX_LEN, per_slot=per_slot)
    tc = tt.init_cache(tcfg, B, MAX_LEN, per_slot=per_slot, device="cpu")
    jl, jc = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))(jp, jc, jb)
    tl, tc = tt.prefill(tcfg, tp, tb, tc)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
    n_img = nb["image_embeds"].shape[1] if "image_embeds" in nb else 0
    assert (tc["len"] == n_img + S).all()
    _cache_equal(tc, jc)
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    for _ in range(4):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tcfg, tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
    _cache_equal(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_a_jax_loop(arch):
    """The serving steps (``make_prefill_step`` / ``make_decode_step``,
    eager, greedy over the pad-masked vocabulary) against a jitted JAX loop
    over ``transformer.prefill`` / ``decode_step``: the same tokens.  Other
    frontend embeddings give another stream (the frames reach every decode
    step through cross-attention, the image rows through the cache)."""
    jcfg, tcfg, jp, tp = _setup(arch, loud=True)
    rng = np.random.default_rng(2)
    nb = {"tokens": rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32),
          **_frontend_inputs(jcfg, rng, B)}
    jb, tb = _both(nb)
    n_new = 10
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    masked = jnp.arange(jcfg.padded_vocab) >= jcfg.vocab_size
    jl, jc = prefill(jp, jt.init_cache(jcfg, B, MAX_LEN), jb)
    want = []
    for _ in range(n_new):
        tok = np.asarray(jnp.argmax(jnp.where(masked, -jnp.inf, jl), axis=-1), np.int32)
        want.append(tok)
        jl, jc = decode(jp, jc, jnp.asarray(tok[:, None]))

    def port_stream(batch):
        tl, tc = make_prefill_step(tcfg)(tp, tt.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                                         batch)
        out = []
        for _ in range(n_new):
            tok = sample_tokens(tl, tcfg.vocab_size, 0.0).to(torch.int32)
            out.append(tok.numpy())
            tl, tc = make_decode_step(tcfg)(tp, tc, tok[:, None])
        return np.stack(out)

    np.testing.assert_array_equal(port_stream(tb), np.stack(want))
    other = {k: (v if k == "tokens" else -v) for k, v in tb.items()}
    assert not np.array_equal(port_stream(other), np.stack(want))


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_and_specs_match_reference(arch, kind):
    """``make_batch`` / ``input_specs``: the reference's keys, shapes and
    dtypes (image embeddings capped at half the sequence)."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    seq = 12 if arch.startswith("llava") else 24
    jshape, tshape = JShapeSpec("s", seq, 2, kind), ShapeSpec("s", seq, 2, kind)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in japi.input_specs(jcfg, jshape).items()}
    jbatch = japi.make_batch(jcfg, jshape, jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in jbatch.items()} == {k: s for k, (s, _) in
                                                              want.items()}
    dt = {"torch.int32": "int32", "torch.bfloat16": "bfloat16"}
    specs = tapi.input_specs(tcfg, tshape, device="cpu")
    assert {k: (tuple(v.shape), dt[str(v.dtype)]) for k, v in specs.items()} == want
    batch = tapi.make_batch(tcfg, tshape, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), dt[str(v.dtype)]) for k, v in batch.items()} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_steps_run_like_eager(arch):
    """The prefill step (with the frontend's embeddings) and the decode
    step captured and run on the CPU runtime as a static plan, under the
    dynamic scheduler and through ``Graph.execute``: eager's logits and
    cache bit for bit.  Every attention is one B3 or B2 node: the encoder's
    and the cross-attention's too."""
    from torch.utils import _pytree as pytree

    _, tcfg, _, tp = _setup(arch, loud=True)
    batch = tapi.make_batch(tcfg, ShapeSpec("p", 2 * S, B, "prefill"),
                            torch.Generator().manual_seed(4))
    cache = tt.init_cache(tcfg, B, MAX_LEN, device="cpu")
    prefill, decode = make_prefill_step(tcfg), make_decode_step(tcfg)
    logits, cache1 = prefill(tp, cache, batch)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    n_enc, n_dec = tcfg.n_encoder_layers, tcfg.n_layers
    cross = n_dec if tcfg.cross_attention else 0
    with Runtime(n_workers=2, device="cpu") as rt:
        for fn, args, flash, dec in ((prefill, (tp, cache, batch), n_enc + n_dec + cross, 0),
                                     (decode, (tp, cache1, toks), cross, n_dec)):
            exe = rt_compile(fn, *args, runtime=rt, jit_nodes=True)
            ops = [o for n in exe.graph.names for o in exe.graph[n].meta.get("ops", ())]
            assert (ops.count("flash_attention"), ops.count("decode_attention")) == (flash, dec)
            want = pytree.tree_leaves(fn(*args))
            inputs = exe.captured.bind(args)
            runs = [exe.captured.unflatten(exe.execute_host(inputs, host_mode=m).outputs)
                    for m in ("static", "dynamic")]
            runs.append(exe.captured.unflatten(exe.graph.execute(inputs)))
            for run in runs:
                got = pytree.tree_leaves(run)
                assert len(got) == len(want)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- engines ---------------------------------------------------------------------

def test_wave_engine_serves_llava_as_text_like_the_reference():
    """The wave engine prefills tokens only, as the reference's does: its
    greedy streams on llava's smoke config equal the JAX wave
    ``ServeEngine.run()``."""
    jcfg, tcfg, jp, tp = _setup("llava-next-34b", loud=True)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jcfg.vocab_size, n).astype(np.int32) for n in (5, 9, 5, 14)]
    new = [6, 4, 7, 5]
    jeng = JServeEngine(jcfg, jp, JServeConfig(max_batch=3, max_len=MAX_LEN))
    for i, (p, n) in enumerate(zip(prompts, new)):
        jeng.submit(JRequest(i, p, max_new_tokens=n))
    want = [r.output for r in jeng.run()]
    eng = serve_engine(tcfg, tp, ServeConfig(max_batch=3, max_len=MAX_LEN), continuous=False,
                       device="cpu")
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(Request(i, p, max_new_tokens=n))
    assert [r.output for r in eng.run()] == want
    assert len({t for s in want for t in s}) > 6


@pytest.mark.parametrize("arch, engine", [(a, e) for a in ARCHS for e in ("slot", "paged")]
                         + [("whisper-medium", "wave")])
def test_engines_refuse_as_the_reference(arch, engine):
    """The slot and paged engines refuse both archs; the wave engine
    serves llava (above) and refuses whisper when it runs a wave."""
    tcfg = get_config(arch, smoke=True)
    scfg = ServeConfig(max_batch=2, max_len=MAX_LEN)
    if engine == "slot":
        with pytest.raises(ValueError, match="continuous batching supports decoder-only"):
            serve_engine(tcfg, {}, scfg, device="cpu")
    elif engine == "paged":
        with pytest.raises(ValueError, match="paged serving requires"):
            serve_engine(tcfg, {}, scfg, paged=PagedConfig(page_size=8), device="cpu")
    else:
        eng = serve_engine(tcfg, tt.init_params(tcfg, 0, device="cpu"), scfg,
                           continuous=False, device="cpu")
        eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), max_new_tokens=2))
        with pytest.raises(ValueError, match="wave requests carry no encoder input"):
            eng.run()


@pytest.mark.parametrize("flags, refused", [
    (["--arch", "whisper-medium"], "no encoder input"),
    (["--arch", "whisper-medium", "--continuous"], "continuous batching"),
    (["--arch", "llava-next-34b", "--continuous"], "continuous batching"),
    (["--arch", "llava-next-34b", "--paged"], "paged serving requires")])
def test_cli_refuses_before_building_weights(flags, refused, monkeypatch):
    def no_weights(*a, **k):
        raise AssertionError("weights built before the refusal")

    monkeypatch.setattr(tt, "init_params", no_weights)
    with pytest.raises(SystemExit, match=refused):
        serve_cli.main(flags + ["--smoke", "--device", "cpu"])


def test_cli_serves_llava_as_text(capsys):
    assert serve_cli.main(["--arch", "llava-next-34b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "6", "--max-new", "3"]) == 0
    assert "[wave] served 3 requests, 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_training_is_still_refused(arch):
    """The name is kept from when training the frontend archs was refused;
    they train now (``tests/test_torch_frontend_train.py`` holds them to
    the reference).  ``check_trainable`` admits the published and the
    smoke config, and a train state builds on the smoke one, encoder
    layers included."""
    from repro_torch.train.step import init_train_state

    for smoke in (False, True):
        tt.check_trainable(get_config(arch, smoke=smoke))
    cfg = get_config(arch, smoke=True)
    state = init_train_state(cfg, 0, device="cpu")
    assert len(state["params"]["layers"]) == cfg.n_layers
    assert len(state["params"].get("enc_layers", [])) == cfg.n_encoder_layers
    assert int(state["step"]) == 0
    from torch.utils import _pytree as pytree

    assert pytree.tree_structure(state["m"]) == pytree.tree_structure(state["params"])


# -- B3's plain version, non-causal ------------------------------------------------

@pytest.mark.parametrize("Sq, Skv, Hq, Hkv", [(7, 16, 4, 4), (1, 16, 4, 4), (1, 23, 4, 2),
                                              (32, 150, 8, 8), (9, 150, 14, 2)])
def test_plain_flash_non_causal_matches_attention_ref(Sq, Skv, Hq, Hkv):
    """Cross-attention's shapes: prompt rows, or one decode row, against a
    longer encoder output; G = 1 and G = 7; a ragged Skv."""
    rng = np.random.default_rng(Sq * 1000 + Skv)
    hd = 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, Sq, Hq, hd), (2, Skv, Hkv, hd), (2, Skv, Hkv, hd)))
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=False, chunk=8, q_chunk=8)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)
