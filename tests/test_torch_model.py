"""The port's paged transformer against the JAX package's, on the same
weights (converted with ``params_from_jax``) and the same numpy inputs.

The reference functions are jitted and called directly (its capture is
broken on the installed JAX, so its engines cannot be built).  f32 at the
smoke size within 2e-5; bf16 within 3e-2 (``tests/test_kernels.py``).
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

PS, B, MAX_LEN, N_PAGES = 8, 3, 64, 24
N_PT = MAX_LEN // PS
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype):
    return (j_get_config("gemma-2b", smoke=True).reduced(dtype=J_DT[dtype]),
            get_config("gemma-2b", smoke=True).reduced(dtype=T_DT[dtype]))


def _params(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg, tcfg, jp, tp = _params(dtype)
    assert len(tp["layers"]) == tcfg.n_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [getattr(k, "key", None) for k in path]
        if keys[0] == "layers":
            for i in range(tcfg.n_layers):
                t = tp["layers"][i]
                for kk in keys[1:]:
                    t = t[kk]
                assert t.dtype == T_DT[dtype]
                np.testing.assert_array_equal(_np(t), np.asarray(leaf[i], np.float32))
        else:
            t = tp
            for kk in keys:
                t = t[kk]
            assert t.dtype == T_DT[dtype]
            np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))


def _reference_fns(jcfg):
    chunk = jax.jit(lambda p, pg, tr, t, s, v: jt.paged_prefill_chunk(
        jcfg, p, t, pg, tr, s, v, page_size=PS))
    insert = jax.jit(lambda pg, tr, s, v, kc, vc: jt.paged_insert_chunk(
        jcfg, pg, tr, s, v, kc, vc, page_size=PS))
    decode = jax.jit(lambda p, c, t: jt.paged_decode_step(jcfg, p, t, c, page_size=PS))
    return chunk, insert, decode


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_insert_decode_match_reference(dtype):
    jcfg, tcfg, jp, tp = _params(dtype)
    j_chunk, j_insert, j_decode = _reference_fns(jcfg)
    rng = np.random.default_rng(1)
    jc = jt.init_paged_cache(jcfg, B, MAX_LEN, n_pages=N_PAGES, page_size=PS)
    tc = tt.init_paged_cache(tcfg, B, MAX_LEN, n_pages=N_PAGES, page_size=PS, device="cpu")
    jpages, tpages = jc["pages"], tc["pages"]
    table = np.full((B, N_PT), -1, np.int32)
    table[0, :3] = [5, 7, 2]
    table[1, :2] = [11, 3]
    lens = np.zeros(B, np.int32)
    tol = TOL[dtype]
    # row 0: a 19-token prompt in two 16-token chunks; row 1: 9 tokens in one
    for row, prompt_len in ((0, 19), (1, 9)):
        toks = rng.integers(0, jcfg.vocab_size, size=prompt_len).astype(np.int32)
        for start in range(0, prompt_len, 16):
            valid = min(16, prompt_len - start)
            chunk = np.zeros((1, 16), np.int32)
            chunk[0, :valid] = toks[start:start + valid]
            jl, jk, jv = j_chunk(jp, jpages, jnp.asarray(table[row]), jnp.asarray(chunk),
                                 jnp.int32(start), jnp.int32(valid))
            tl, tk, tv = tt.paged_prefill_chunk(
                tcfg, tp, _i32(chunk), tpages, _i32(table[row]), _i32(start), _i32(valid),
                page_size=PS)
            np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32), atol=tol, rtol=tol)
            jpages = j_insert(jpages, jnp.asarray(table[row]), jnp.int32(start),
                              jnp.int32(valid), jk, jv)
            tpages = tt.paged_insert_chunk(tcfg, tpages, table[row], start, valid, tk, tv,
                                           page_size=PS)
        lens[row] = prompt_len
    tokens = np.array([[3], [5], [0]], np.int32)          # row 2 idle
    for _ in range(4):
        jl, jcache = j_decode(jp, {"len": jnp.asarray(lens), "table": jnp.asarray(table),
                                   "pages": jpages}, jnp.asarray(tokens))
        tl, tcache = tt.paged_decode_step(
            tcfg, tp, _i32(tokens), {"len": _i32(lens), "table": _i32(table), "pages": tpages},
            page_size=PS)
        np.testing.assert_allclose(_np(tl)[:2], np.asarray(jl, np.float32)[:2],
                                   atol=tol, rtol=tol)
        jpages, tpages = jcache["pages"], tcache["pages"]
        np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
        tokens = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        tokens[2] = 0
        lens[:2] += 1
    # pools equal on every mapped page
    stacked = tt.pages_to_stacked(tpages)
    mapped = np.unique(table[table >= 0])
    for kk in ("k", "v"):
        np.testing.assert_allclose(stacked[kk][:, mapped],
                                   np.asarray(jpages[kk], np.float32)[:, mapped],
                                   atol=tol, rtol=tol)


def test_pages_round_trip_through_reference_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    rng = np.random.default_rng(2)
    shape = (tcfg.n_layers, N_PAGES, PS, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    np_pages = {kk: rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)
                for kk in ("k", "v")}
    pages = tt.pages_from_jax(tcfg, np_pages, device="cpu")
    assert pages[0]["k"].dtype == torch.bfloat16
    back = tt.pages_to_stacked(pages)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(back[kk], np_pages[kk].astype(np.float32))


def test_copy_page_matches_reference():
    jcfg, tcfg = _cfgs("float32")
    rng = np.random.default_rng(3)
    shape = (tcfg.n_layers, N_PAGES, PS, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    np_pages = {kk: rng.standard_normal(shape).astype(np.float32) for kk in ("k", "v")}
    jout = jt.paged_copy_page(jcfg, {kk: jnp.asarray(v) for kk, v in np_pages.items()}, 4, 9)
    tpages = tt.pages_from_jax(tcfg, np_pages, device="cpu")
    tout = tt.paged_copy_page(tcfg, tpages, 4, 9)
    stacked = tt.pages_to_stacked(tout)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(stacked[kk], np.asarray(jout[kk]))
        # out of place: the input pools are untouched
        np.testing.assert_array_equal(tt.pages_to_stacked(tpages)[kk], np_pages[kk])


def _sentinel_pages(tcfg):
    return [{kk: torch.full((N_PAGES, PS, tcfg.n_kv_heads, tcfg.resolved_head_dim), 7.0)
             for kk in ("k", "v")} for _ in range(tcfg.n_layers)]


def test_idle_decode_row_writes_no_page():
    _, tcfg, _, tp = _params("float32")
    pages = _sentinel_pages(tcfg)
    table = np.full((B, N_PT), -1, np.int32)
    table[0, 0] = 2
    lens = np.array([3, 0, 0], np.int32)          # rows 1 and 2 idle: no mapped page
    _, cache = tt.paged_decode_step(tcfg, tp, _i32([[1], [2], [3]]),
                                    {"len": _i32(lens), "table": _i32(table), "pages": pages},
                                    page_size=PS)
    for pg in cache["pages"]:
        for kk in ("k", "v"):
            changed = (pg[kk] != 7.0).flatten(1).any(dim=1).nonzero()[:, 0].tolist()
            assert changed == [2]                  # only row 0's tail page, never P-1
            assert (pg[kk][2, 3] != 7.0).all() and (pg[kk][2, :3] == 7.0).all()


def test_padded_chunk_positions_write_no_page():
    _, tcfg, _, tp = _params("float32")
    pages = _sentinel_pages(tcfg)
    table_row = np.full((N_PT,), -1, np.int32)
    table_row[:2] = [0, 5]
    _, kc, vc = tt.paged_prefill_chunk(tcfg, tp, _i32(np.ones((1, 16))), pages,
                                       _i32(table_row), _i32(0), _i32(11), page_size=PS)
    out = tt.paged_insert_chunk(tcfg, pages, table_row, 0, 11, kc, vc, page_size=PS)
    for pg in out:
        for kk in ("k", "v"):
            changed = (pg[kk] != 7.0).flatten(1).any(dim=1).nonzero()[:, 0].tolist()
            assert changed == [0, 5]
            assert (pg[kk][5, 3:] == 7.0).all()    # positions 11..15 are padding
            assert (pg[kk][N_PAGES - 1] == 7.0).all()
