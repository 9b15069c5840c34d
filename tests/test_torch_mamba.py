"""falcon-mamba-7b (Mamba-1, smoke size, f32) through the port's model
functions on the CPU, against the JAX package on the same weights
(``params_from_jax``) and the same numpy inputs: the Mamba layer's prefill
and decode step, the whole model's prefill plus 8 decode steps (logits
within 2e-5, greedy streams equal), and slot insert / evict on the state
cache.  The reference runs its selective scan in jnp (``ssm_scan_fused``);
the port runs kernel B6's op, whose plain version a CPU tensor takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba as jm
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as tt

ARCH = "falcon-mamba-7b"
TOL = 2e-5
MAX_LEN = 64


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config(ARCH, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(ARCH, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(1))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _layer(jp, i):
    """Layer i's Mamba params of the reference's stacked [L, ...] tree."""
    return jax.tree.map(lambda a: a[i], jp["layers"]["ssm"])


def test_params_keep_each_leafs_dtype_and_the_reference_shapes():
    jcfg = j_get_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    jp = jt.init_params(jcfg, jax.random.key(0))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    own = tt.init_params(tcfg, 0, device="cpu")
    for params in (tp, own):
        assert len(params["layers"]) == tcfg.n_layers
        lp = params["layers"][1]
        assert set(lp) == {"ln1", "ssm"}                 # a Mamba layer has no FFN
        ssm = lp["ssm"]
        assert all(ssm[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
        assert all(ssm[k].dtype == torch.bfloat16
                   for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "out_proj"))
        for k, v in ssm.items():
            assert tuple(v.shape) == jp["layers"]["ssm"][k].shape[1:], k
    np.testing.assert_array_equal(tp["layers"][1]["ssm"]["A_log"].numpy(),
                                  np.asarray(jp["layers"]["ssm"]["A_log"][1]))
    # the S4D-real init and dt's bias are deterministic: the same numbers
    np.testing.assert_allclose(own["layers"][0]["ssm"]["A_log"].numpy(),
                               np.asarray(jp["layers"]["ssm"]["A_log"][0]), rtol=1e-7)
    np.testing.assert_allclose(own["layers"][0]["ssm"]["dt_bias"].numpy(),
                               np.asarray(jp["layers"]["ssm"]["dt_bias"][0]), rtol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 13])
def test_mamba_prefill_matches_reference(model, S):
    """Output and the decode state it leaves (``h``, the conv's last K-1
    inputs).  Below K-1 = 3 tokens the reference's slice holds only S rows;
    the port's keeps the cache's K-1, zero-padded in front."""
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout, jc = jt._mamba_prefill(_layer(jp, 1), jnp.asarray(x), None)
    tout, tc = tm.mamba_prefill(tp["layers"][1]["ssm"], torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tc["h"].numpy(), _np(jc["h"]), atol=TOL, rtol=TOL)
    K = jcfg.ssm_conv
    assert tuple(tc["conv"].shape) == (2, K - 1, jcfg.d_inner)
    n = min(S, K - 1)
    np.testing.assert_allclose(tc["conv"][:, K - 1 - n:].numpy(), _np(jc["conv"])[:, -n:],
                               atol=TOL, rtol=TOL)
    assert not tc["conv"][:, :K - 1 - n].any()
    # and mamba_block is its output alone
    assert torch.equal(tm.mamba_block(tp["layers"][1]["ssm"], torch.from_numpy(x)), tout)
    np.testing.assert_allclose(tout.numpy(), _np(jm.mamba_block(_layer(jp, 1), jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


def test_mamba_decode_step_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    B = 3
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((B, jcfg.d_inner, jcfg.ssm_state)).astype(np.float32),
             "conv": rng.standard_normal((B, jcfg.ssm_conv - 1, jcfg.d_inner)).astype(np.float32)}
    jout, jc = jm.mamba_decode_step(_layer(jp, 0), jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, cache))
    before = ssm_scan_cuda.launches
    tout, tc = tm.mamba_decode_step(tp["layers"][0]["ssm"], torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in cache.items()})
    assert ssm_scan_cuda.launches == before
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=TOL, rtol=TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("form", ["per_slot", "shared"])
def test_prefill_and_eight_decode_steps_match_reference(model, form):
    """The whole model: logits within 2e-5 at every step, and the greedy
    streams equal."""
    jcfg, tcfg, jp, tp = model
    per_slot = form == "per_slot"
    B = 1 if per_slot else 2
    toks = np.random.default_rng(3).integers(1, 500, (B, 19)).astype(np.int32)
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jp, jt.init_cache(jcfg, B, MAX_LEN, per_slot=per_slot),
                     {"tokens": jnp.asarray(toks)})
    tl, tc = tt.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                        tt.init_cache(tcfg, B, MAX_LEN, per_slot=per_slot, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    st = tt.cache_to_stacked(tc)
    np.testing.assert_allclose(st["layers"]["h"], _np(jc["layers"]["h"]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(st["len"], np.asarray(jc["len"]))
    V = tcfg.vocab_size
    jstream, tstream = [], []
    for _ in range(8):
        jt_ = np.asarray(jnp.argmax(jl[:, :V], axis=-1)).astype(np.int32)[:, None]
        tt_ = torch.argmax(tl[:, :V], dim=-1).to(torch.int32)[:, None]
        jstream.append(jt_[:, 0].tolist())
        tstream.append(tt_[:, 0].tolist())
        jl, jc = decode(jp, jc, jnp.asarray(jt_))
        tl, tc = tt.decode_step(tcfg, tp, tt_, tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    assert tstream == jstream
    np.testing.assert_allclose(tt.cache_to_stacked(tc)["layers"]["conv"],
                               _np(jc["layers"]["conv"]), atol=TOL, rtol=TOL)


def test_valid_len_and_paged_cache_are_refused(model):
    _, tcfg, _, tp = model
    cache = tt.init_cache(tcfg, 1, MAX_LEN, per_slot=True, device="cpu")
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "valid_len": torch.tensor(5, dtype=torch.int32)}
    with pytest.raises(ValueError, match="attention-only"):
        tt.prefill(tcfg, tp, batch, cache)
    with pytest.raises(ValueError, match="paged KV cache requires"):
        tt.init_paged_cache(tcfg, 2, MAX_LEN, n_pages=8, page_size=8, device="cpu")
    assert not tt.paged_supported(tcfg)


def _random_state_cache(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    c = jax.tree.map(np.array, jt.init_cache(jcfg, B, MAX_LEN, per_slot=True))
    for k in ("h", "conv"):
        c["layers"][k] = rng.standard_normal(c["layers"][k].shape).astype(np.float32)
    c["len"] = rng.integers(0, 30, B).astype(np.int32)
    return c


def test_insert_and_evict_slot_match_reference(model):
    """Insert overwrites the slot's whole state; evict touches only the
    length (a state layer has no position table and gains none)."""
    jcfg, tcfg, _, _ = model
    big = _random_state_cache(jcfg, 4, seed=4)
    sub = _random_state_cache(jcfg, 1, seed=5)
    tbig, tsub = tt.cache_from_jax(tcfg, big, device="cpu"), tt.cache_from_jax(tcfg, sub,
                                                                                device="cpu")
    assert tbig["layers"][0]["h"].dtype == torch.float32
    jins = jt.cache_insert_slot(jcfg, jax.tree.map(jnp.asarray, big),
                                jax.tree.map(jnp.asarray, sub), 2)
    tins = tt.cache_insert_slot(tcfg, tbig, tsub, 2)
    st = tt.cache_to_stacked(tins)
    for k in ("h", "conv"):
        np.testing.assert_array_equal(st["layers"][k], _np(jins["layers"][k]))
    np.testing.assert_array_equal(st["len"], np.asarray(jins["len"]))
    jev = jt.cache_evict_slot(jcfg, jins, 1)
    tev = tt.cache_evict_slot(tcfg, tins, 1)
    assert all(set(lc) == {"h", "conv"} for lc in tev["layers"])
    st = tt.cache_to_stacked(tev)
    for k in ("h", "conv"):
        np.testing.assert_array_equal(st["layers"][k], _np(jev["layers"][k]))
    np.testing.assert_array_equal(st["len"], np.asarray(jev["len"]))
