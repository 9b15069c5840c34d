"""The port's dense-cache transformer (what the slot and wave engines run)
against the JAX package's, on the same weights (``params_from_jax``) and
the same caches (``cache_from_jax``).

Covers ``prefill`` with and without ``valid_len`` (shared and per-slot
caches), ``decode_step`` in both cache forms, ``cache_insert_slot`` and
``cache_evict_slot``, and a sliding-window variant whose cache is a ring
buffer shorter than the prompt.  The reference functions are jitted and
called directly.  f32 at the smoke size within 2e-5; bf16 within 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt

MAX_LEN = 40
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(dtype, window=None):
    jcfg = j_get_config("gemma-2b", smoke=True).reduced(dtype=J_DT[dtype],
                                                         sliding_window=window)
    tcfg = get_config("gemma-2b", smoke=True).reduced(dtype=T_DT[dtype], sliding_window=window)
    jp = jt.init_params(jcfg, jax.random.key(0))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _assert_caches_close(jcache, tcache, dtype, rows=None):
    js = jax.tree.map(np.asarray, jcache)
    ts = tt.cache_to_stacked(tcache)
    np.testing.assert_array_equal(np.asarray(js["len"]), ts["len"])
    for kk in ("k", "v", "pos"):
        a, b = _np(js["layers"][kk]), ts["layers"][kk]
        if rows is not None:
            a, b = a[:, rows], b[:, rows]
        if kk == "pos":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, atol=TOL[dtype], rtol=TOL[dtype])


def _j_prefill(jcfg):
    return jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))


def _j_decode(jcfg):
    return jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))


@pytest.mark.parametrize("variant", ["full", "valid_len", "shared", "sliding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype, variant):
    window = 8 if variant == "sliding" else None
    jcfg, tcfg, jp, tp = _setup(dtype, window)
    per_slot = variant != "shared"
    B = 1 if per_slot else 2
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, (B, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.as_tensor(toks)}
    if variant == "valid_len":
        jbatch["valid_len"] = jnp.int32(11)
        tbatch["valid_len"] = torch.tensor(11, dtype=torch.int32)
    jl, jc = _j_prefill(jcfg)(jp, jt.init_cache(jcfg, B, MAX_LEN, per_slot=per_slot), jbatch)
    tl, tc = tt.prefill(tcfg, tp, tbatch,
                        tt.init_cache(tcfg, B, MAX_LEN, per_slot=per_slot, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL[dtype], rtol=TOL[dtype])
    _assert_caches_close(jc, tc, dtype)
    if variant == "sliding":
        assert tc["layers"][0]["k"].shape[1] == window


def _slot_cache(jcfg, B, lens, seed=5):
    """A per-slot reference cache with random K/V, rows filled to ``lens``
    (a row past the cache length has wrapped) and one idle row."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(np.asarray, jt.init_cache(jcfg, B, MAX_LEN, per_slot=True))
    lay = jc["layers"]
    dt = lay["k"].dtype
    lay["k"] = rng.standard_normal(lay["k"].shape).astype(np.float32).astype(dt)
    lay["v"] = rng.standard_normal(lay["v"].shape).astype(np.float32).astype(dt)
    C = lay["pos"].shape[-1]
    pos = np.full((B, C), -1, np.int32)
    for b, n in enumerate(lens):
        p = np.arange(max(0, n - C), n, dtype=np.int32)
        pos[b, p % C] = p
    lay["pos"] = np.broadcast_to(pos, lay["pos"].shape).copy()
    jc["len"] = np.asarray(lens, np.int32)
    return jc


@pytest.mark.parametrize("form", ["per_slot", "shared", "sliding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype, form):
    window = 8 if form == "sliding" else None
    jcfg, tcfg, jp, tp = _setup(dtype, window)
    if form == "shared":
        B = 3
        jc = jax.tree.map(np.array, jt.init_cache(jcfg, B, MAX_LEN))
        rng = np.random.default_rng(6)
        dt = jc["layers"]["k"].dtype
        for kk in ("k", "v"):
            jc["layers"][kk] = rng.standard_normal(jc["layers"][kk].shape).astype(
                np.float32).astype(dt)
        jc["layers"]["pos"][:, :13] = np.arange(13, dtype=np.int32)
        jc["len"] = np.asarray(13, np.int32)
        live = slice(None)
    else:
        B = 4
        jc = _slot_cache(jcfg, B, [5, 20, 13 if form == "per_slot" else 23, 0])
        live = slice(0, 3)
    tc = tt.cache_from_jax(tcfg, jc, device="cpu")
    jc = jax.tree.map(jnp.asarray, jc)
    decode = _j_decode(jcfg)
    rng = np.random.default_rng(8)
    for _ in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok))
        tl, tc = tt.decode_step(tcfg, tp, torch.as_tensor(tok), tc)
        np.testing.assert_allclose(tl.numpy()[live], _np(jl)[live], atol=TOL[dtype],
                                   rtol=TOL[dtype])
    _assert_caches_close(jc, tc, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insert_and_evict_slot_match_reference(dtype):
    jcfg, tcfg, jp, tp = _setup(dtype)
    B = 3
    jc = _slot_cache(jcfg, B, [7, 0, 12])
    tc = tt.cache_from_jax(tcfg, jc, device="cpu")
    jc = jax.tree.map(jnp.asarray, jc)
    toks = np.random.default_rng(9).integers(1, 400, (1, 8)).astype(np.int32)
    _, jsub = _j_prefill(jcfg)(jp, jt.init_cache(jcfg, 1, MAX_LEN, per_slot=True),
                               {"tokens": jnp.asarray(toks), "valid_len": jnp.int32(6)})
    _, tsub = tt.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks),
                                    "valid_len": torch.tensor(6, dtype=torch.int32)},
                         tt.init_cache(tcfg, 1, MAX_LEN, per_slot=True, device="cpu"))
    jins = jax.jit(lambda c, s, i: jt.cache_insert_slot(jcfg, c, s, i))
    jev = jax.jit(lambda c, i: jt.cache_evict_slot(jcfg, c, i))
    jc = jins(jc, jsub, jnp.int32(1))
    tc = tt.cache_insert_slot(tcfg, tc, tsub, 1)
    _assert_caches_close(jc, tc, dtype)
    jc = jev(jc, jnp.int32(2))
    tc = tt.cache_evict_slot(tcfg, tc, torch.tensor(2))
    _assert_caches_close(jc, tc, dtype)
    assert int(tc["len"][2]) == 0 and bool((tc["layers"][0]["pos"][2] == -1).all())


def test_cache_conversion_round_trips():
    jcfg, tcfg, _, _ = _setup("bfloat16")
    jc = _slot_cache(jcfg, 2, [4, 9])
    tc = tt.cache_from_jax(tcfg, jc, device="cpu")
    assert len(tc["layers"]) == tcfg.n_layers and tc["layers"][0]["k"].dtype == torch.bfloat16
    back = tt.cache_to_stacked(tc)
    for kk in ("k", "v", "pos"):
        np.testing.assert_array_equal(back["layers"][kk], _np(jc["layers"][kk]))


def test_prefill_and_decode_capture_without_data_dependent_ops():
    """The engines capture these steps with make_fx: no .item(), no
    nonzero, both attention calls as single nodes."""
    from repro_torch.api import compile as rt_compile
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    _, tcfg, _, tp = _setup("float32")
    sub = tt.init_cache(tcfg, 1, MAX_LEN, per_slot=True, device="cpu")
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "valid_len": torch.tensor(5, dtype=torch.int32)}
    cache = tt.init_cache(tcfg, 2, MAX_LEN, per_slot=True, device="cpu")
    toks = torch.ones((2, 1), dtype=torch.int32)
    with Runtime(n_workers=2, device="cpu") as rt:
        for fn, args, op in ((make_prefill_step(tcfg), (tp, sub, batch), "flash_attention"),
                             (make_decode_step(tcfg), (tp, cache, toks), "decode_attention")):
            exe = rt_compile(fn, *args, runtime=rt, jit_nodes=True)
            ops = [exe.graph[n].meta.get("ops", ()) for n in exe.graph.names]
            assert sum(o.count(op) for o in ops) == tcfg.n_layers
            assert not any("nonzero" in o or "_local_scalar_dense" in o for o in ops)
            ref = fn(*args)
            got = exe(*args)
            assert torch.equal(got[0], ref[0])
