"""recurrentgemma-2b (Griffin: RG-LRU, RG-LRU, local MQA; smoke size, f32)
through the port's model functions on the CPU, against the JAX package on
the same weights (``params_from_jax``; its layers come as a list, not
stacked) and the same numpy inputs: the RG-LRU block's prefill and decode
step, the whole model's prefill plus 8 decode steps over prompts longer
than the 16-token window (the attention layer's ring cache wraps; logits
within 2e-5, greedy streams equal), and slot insert / evict on the mixed
state and KV cache.  The reference runs its recurrence in jnp
(``linear_recurrence_chunked``); the port runs kernel B7's op, whose plain
version a CPU tensor takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import griffin as jg
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.models import griffin as tg
from repro_torch.models import transformer as tt

ARCH = "recurrentgemma-2b"
TOL = 2e-5
MAX_LEN = 64


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config(ARCH, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(ARCH, smoke=True).reduced(dtype=torch.float32)
    # a smaller tied embedding (the same numbers in both packages), so the
    # blocks, not the embedding's echo of the last token, pick greedy tokens
    jp = jt.init_params(jcfg, jax.random.key(1))
    jp = {**jp, "embed": jp["embed"] / 8}
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_params_keep_each_leafs_dtype_and_the_reference_shapes():
    jcfg = j_get_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    assert tcfg.layer_kinds() == ["rglru", "rglru", "attn"] and not tcfg.scan_layers
    jp = jt.init_params(jcfg, jax.random.key(0))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    own = tt.init_params(tcfg, 0, device="cpu")
    for params in (tp, own):
        assert "unembed" not in params                   # tied embedding
        assert [set(lp) for lp in params["layers"]] == [
            {"ln1", "rnn", "ln2", "mlp"}, {"ln1", "rnn", "ln2", "mlp"},
            {"ln1", "attn", "ln2", "mlp"}]
        rnn = params["layers"][0]["rnn"]
        assert rnn["lam"].dtype == torch.float32
        assert all(v.dtype == torch.bfloat16 for k, v in rnn.items() if k != "lam")
        for i, lp in enumerate(params["layers"]):
            for k, v in lp.items():
                want = jax.tree.map(lambda a: a.shape, jp["layers"][i][k])
                got = jax.tree.map(lambda t: tuple(t.shape), v) if isinstance(v, dict) \
                    else tuple(v.shape)
                assert got == want, (i, k)
    np.testing.assert_allclose(own["layers"][1]["rnn"]["lam"].numpy(),
                               np.asarray(jp["layers"][1]["rnn"]["lam"]), rtol=1e-5)


@pytest.mark.parametrize("S", [1, 21])
def test_rglru_prefill_matches_reference(model, S):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout, jc = jt._rglru_prefill(jp["layers"][0]["rnn"], jnp.asarray(x), None)
    tout, tc = tg.rglru_prefill(tp["layers"][0]["rnn"], torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tc["h"].numpy(), _np(jc["h"]), atol=TOL, rtol=TOL)
    K = jcfg.ssm_conv
    n = min(S, K - 1)
    assert tuple(tc["conv"].shape) == (2, K - 1, jcfg.rnn_width)
    np.testing.assert_allclose(tc["conv"][:, K - 1 - n:].numpy(), _np(jc["conv"])[:, -n:],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tg.rglru_block(tp["layers"][0]["rnn"], torch.from_numpy(x)),
                               _np(jg.rglru_block(jp["layers"][0]["rnn"], jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


def test_rglru_decode_step_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    B = 3
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((B, jcfg.rnn_width)).astype(np.float32),
             "conv": rng.standard_normal((B, jcfg.ssm_conv - 1, jcfg.rnn_width))
                        .astype(np.float32)}
    jout, jc = jg.rglru_decode_step(jp["layers"][1]["rnn"], jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, cache))
    before = rglru_scan_cuda.launches
    tout, tc = tg.rglru_decode_step(tp["layers"][1]["rnn"], torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in cache.items()})
    assert rglru_scan_cuda.launches == before
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=TOL, rtol=TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), atol=TOL, rtol=TOL)


def _compare_layers(tc, jc):
    st = tt.cache_to_stacked(tc)
    assert isinstance(st["layers"], list)                # the reference's mixed layout
    for tl, jl in zip(st["layers"], jc["layers"]):
        assert set(tl) == set(jl)
        for k in tl:
            np.testing.assert_allclose(tl[k], _np(jl[k]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(st["len"], np.asarray(jc["len"]))


@pytest.mark.parametrize("form", ["per_slot", "shared"])
def test_prefill_and_eight_decode_steps_match_reference(model, form):
    """A 21-token prompt, over the 16-token window: the attention layer's
    ring cache wraps in prefill and again in decode."""
    jcfg, tcfg, jp, tp = model
    assert jcfg.sliding_window == 16
    per_slot = form == "per_slot"
    B = 1 if per_slot else 2
    toks = np.random.default_rng(3).integers(1, 500, (B, 21)).astype(np.int32)
    prefill = jax.jit(lambda p, c, b: jt.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, t, c))
    jl, jc = prefill(jp, jt.init_cache(jcfg, B, MAX_LEN, per_slot=per_slot),
                     {"tokens": jnp.asarray(toks)})
    tl, tc = tt.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                        tt.init_cache(tcfg, B, MAX_LEN, per_slot=per_slot, device="cpu"))
    assert tc["layers"][2]["k"].shape[1] == 16
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=TOL)
    _compare_layers(tc, jc)
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
    assert len({t for step in tstream for t in step}) > 4   # not a repeat loop
    _compare_layers(tc, jc)


def test_valid_len_and_paged_cache_are_refused(model):
    _, tcfg, _, tp = model
    cache = tt.init_cache(tcfg, 1, MAX_LEN, per_slot=True, device="cpu")
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "valid_len": torch.tensor(5, dtype=torch.int32)}
    with pytest.raises(ValueError, match="attention-only"):
        tt.prefill(tcfg, tp, batch, cache)
    with pytest.raises(ValueError, match="paged KV cache requires"):
        tt.init_paged_cache(tcfg, 2, MAX_LEN, n_pages=8, page_size=8, device="cpu")


def _random_cache(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    c = jax.tree.map(np.array, jt.init_cache(jcfg, B, MAX_LEN, per_slot=True))
    for lc in c["layers"]:
        for k in lc:
            if k == "pos":
                lc[k] = rng.integers(-1, 30, lc[k].shape).astype(np.int32)
            else:
                lc[k] = rng.standard_normal(lc[k].shape).astype(np.float32)
    c["len"] = rng.integers(0, 30, B).astype(np.int32)
    return c


def test_insert_and_evict_slot_match_reference(model):
    """Insert copies every leaf of the slot (state and K/V); evict clears
    only the attention layer's positions, and the state layers gain no
    ``pos``."""
    jcfg, tcfg, _, _ = model
    big, sub = _random_cache(jcfg, 4, seed=4), _random_cache(jcfg, 1, seed=5)
    jins = jt.cache_insert_slot(jcfg, jax.tree.map(jnp.asarray, big),
                                jax.tree.map(jnp.asarray, sub), 3)
    tins = tt.cache_insert_slot(tcfg, tt.cache_from_jax(tcfg, big, device="cpu"),
                                tt.cache_from_jax(tcfg, sub, device="cpu"), 3)
    _compare_layers(tins, jins)
    jev = jt.cache_evict_slot(jcfg, jins, 0)
    tev = tt.cache_evict_slot(tcfg, tins, 0)
    assert [set(lc) for lc in tev["layers"]] == [{"h", "conv"}, {"h", "conv"},
                                                 {"k", "v", "pos"}]
    assert (tev["layers"][2]["pos"][0] == -1).all()
    _compare_layers(tev, jev)
