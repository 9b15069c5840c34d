"""The port's distribution layer on real ranks: CPU ``gloo`` groups of up to
four processes (``torch_dist_workers.launch``), each rank importing torch
and the port alone, held to numpy and to the JAX package's unsharded
functions in this process.

* the ring matmuls: the all-gather ring bit-equal to ``x @ w``'s rows of
  each column block, the reduce-scatter ring within 1e-5 relative (f32);
* ``compressed_psum``: equal to a numpy run of the same quantization, its
  error under 0.05 relative, and shrinking under error feedback;
* the smoke gemma-2b and granite-moe-1b-a400m at ``2x2``: loss and every
  gradient, and a train step's metrics, within 1e-4 of the reference's
  unsharded ``lm_loss`` / ``make_train_step`` on the same weights
  (``params_from_jax``).  On a mesh the reference's MoE routes each
  data-parallel group apart (``_infer_groups`` gives the data extent); its
  unsharded step is run with that grouping, 2 groups;
* the sequence-sharded decode step against the reference's
  ``decode_step`` within 2e-5 (f32), a rank holding no live cache entry
  among the cases;
* the elastic restore: a checkpoint one process wrote, restored onto
  ``2x2`` and gathered back, bit for bit.

Each group has its own timeout (``launch``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import transformer as jt
from repro.train import step as jstep

TOL = 1e-4
DECODE_TOL = 2e-5
WORLD = 4
MESH = (2, 2)
ARCHS = ("gemma-2b", "granite-moe-1b-a400m")
B, S = 4, 16


def _jcfg(arch):
    return j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1
    return {"tokens": toks[:, :S].copy(), "labels": labels}


def _jkeys(path):
    return [getattr(k, "key", getattr(k, "idx", None)) for k in path]


def _port_key(keys, i=None):
    """The port's ``keystr`` of a reference leaf (its stacked layer ``i``)."""
    parts = [keys[0]] + ([i] if i is not None else []) + keys[1:]
    return "".join(f"[{p!r}]" for p in parts)


def _ref_grads(jg):
    """{port keystr: reference gradient} with the stacked layers split."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        keys = _jkeys(path)
        arr = np.asarray(leaf)
        if keys[0] in ("layers", "enc_layers") and not isinstance(keys[1], int):
            for i in range(arr.shape[0]):
                out[_port_key(keys, i)] = arr[i]
        else:
            out[_port_key(keys)] = arr
    return out


def _ring_payload():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = rng.standard_normal((24, 32)).astype(np.float32)
    g = rng.standard_normal((WORLD, 64)).astype(np.float32)
    return {"x": x, "w": w, "g": g, "steps": 8, "bits": 8}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every body in one gloo group of WORLD ranks (one start-up for all),
    with the reference's results computed here."""
    payload = _ring_payload()
    train_payload, refs = _train_setup()
    cases, state, ckpt, decode_params = _decode_restore_setup(tmp_path_factory)
    payload.update(train_payload)
    payload.update({"arch": "gemma-2b", "dir": ckpt, "cases": [c for c, _, _ in cases],
                    "decode_params": decode_params})
    res = workers.launch(WORLD, ["ring", "compress", "train", "decode", "restore"], payload,
                         timeout=300)
    return {"payload": payload, "refs": refs, "cases": cases, "state": state, "res": res}


@pytest.fixture(scope="module")
def ring_results(ranks):
    return ranks["payload"], ranks["res"]


def test_ring_allgather_matmul_is_exact(ring_results):
    payload, res = ring_results
    x, w = payload["x"], payload["w"]
    c = w.shape[1] // WORLD
    for r in range(WORLD):
        got = res[r]["ring"]["allgather"]
        wl = torch.from_numpy(w[:, r * c:(r + 1) * c])
        m = x.shape[0] // WORLD
        # the ring multiplies one rank's rows at a time: the same products
        want = torch.cat([torch.from_numpy(x[j * m:(j + 1) * m]) @ wl for j in range(WORLD)])
        assert np.array_equal(got, want.numpy())
        np.testing.assert_allclose(got, x @ w[:, r * c:(r + 1) * c], rtol=1e-5, atol=1e-5)


def test_ring_reducescatter_matmul_matches(ring_results):
    payload, res = ring_results
    full = payload["x"].astype(np.float64) @ payload["w"].astype(np.float64)
    rows = full.shape[0] // WORLD
    for r in range(WORLD):
        got = res[r]["ring"]["reducescatter"]
        want = full[r * rows:(r + 1) * rows]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _np_compressed(g, steps, bits):
    """The same quantization in numpy: (mean per step) with error feedback."""
    levels = float(2 ** (bits - 1) - 1)
    err = np.zeros_like(g)
    means = []
    for _ in range(steps):
        comp = g + err
        scale = np.maximum(np.abs(comp).max(axis=1) / levels, 1e-12).astype(np.float32)
        q = np.clip(np.round(comp / scale[:, None]), -levels, levels)
        err = comp - q * scale[:, None]
        means.append((q * scale[:, None]).sum(0) / g.shape[0])
    return means


def test_compressed_psum_matches_numpy_and_feedback_shrinks(ring_results):
    payload, res = ring_results
    g = payload["g"]
    want = _np_compressed(g, payload["steps"], payload["bits"])
    true = g.mean(0)
    for r in range(WORLD):
        means = res[r]["compress"]["means"]
        for got, ref in zip(means, want):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    means = res[0]["compress"]["means"]
    rel = np.linalg.norm(means[0] - true) / np.linalg.norm(true)
    assert rel < 0.05
    # error feedback: the running average of the reconstructed means
    # converges on the true mean
    errs = [np.linalg.norm(np.mean(means[:k], 0) - true) for k in (1, 2, 4, 8)]
    assert errs[-1] < errs[0]


def _train_setup():
    """(payload, reference results) for the train body."""
    params, batches, refs = {}, {}, {}
    for arch in ARCHS:
        jcfg = _jcfg(arch)
        jp = jt.init_params(jcfg, jax.random.key(0))
        params[arch] = _np(jp)
        batch = batches[arch] = _batch(jcfg.vocab_size)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        from repro.models import moe as jmoe

        orig = jmoe._infer_groups
        jmoe._infer_groups = lambda T: MESH[0] if T % MESH[0] == 0 else 1
        try:
            (jl, jparts), jg = jax.value_and_grad(
                lambda p: japi.lm_loss(jcfg, p, jb), has_aux=True)(jp)
            jtc = jstep.TrainStepConfig(remat=True)
            jstate = {"params": jp, **jstep.adamw_init(jp, jtc.adamw)}
            _, jm = jstep.make_train_step(jcfg, jtc)(jstate, jb)
        finally:
            jmoe._infer_groups = orig
        refs[arch] = {"loss": float(jl), "aux": float(jparts["aux"]), "grads": _ref_grads(jg),
                      "metrics": {k: float(v) for k, v in jm.items()}}
    return {"params": params, "batch": batches, "mesh": MESH}, refs


@pytest.fixture(scope="module")
def train_results(ranks):
    return ranks["refs"], ranks["res"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_reference(train_results, arch):
    refs, res = train_results
    ref = refs[arch]
    for r in range(WORLD):
        got = res[r]["train"][arch]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=TOL, atol=TOL)
        grads = dict(got["grads"])
        assert set(grads) == set(ref["grads"])
        for name, want in ref["grads"].items():
            np.testing.assert_allclose(grads[name], want, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(train_results, arch):
    refs, res = train_results
    want = refs[arch]["metrics"]
    for r in range(WORLD):
        got = res[r]["train"][arch]["metrics"]
        for k in ("loss", "ce", "aux", "grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def _decode_cases(jcfg, jp):
    """(cache after a prefill, next tokens, reference logits and cache) for a
    short prompt (the second model rank's half of the 16-entry cache holds
    no live entry) and a long one (both halves live)."""
    cases = []
    rng = np.random.default_rng(7)
    for plen in (3, 12):
        toks = rng.integers(0, jcfg.vocab_size, (B, plen)).astype(np.int32)
        cache = jt.init_cache(jcfg, B, 16)
        _, cache = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache)
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        logits, new = jt.decode_step(jcfg, jp, jnp.asarray(nxt), cache)
        cases.append(({"cache": _np(cache), "tokens": nxt}, np.asarray(logits), _np(new)))
    return cases


def _decode_restore_setup(tmp_path_factory):
    """(decode cases with their reference results, the saved state, the
    checkpoint directory, the decode weights)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.train.step import init_train_state

    jcfg = _jcfg("gemma-2b")
    jp = jt.init_params(jcfg, jax.random.key(2))
    cases = _decode_cases(jcfg, jp)
    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    state = init_train_state(cfg, 5, device="cpu")
    state["m"] = {**state["m"], "final_norm": torch.randn(cfg.d_model)}
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(ckpt, 3, state)
    return cases, state, ckpt, _np(jp)


@pytest.fixture(scope="module")
def decode_and_restore(ranks):
    return ranks["cases"], ranks["state"], ranks["res"]


def _layer0(cache, name):
    """Layer 0's ``name`` leaf of a reference cache, stacked or a list."""
    layers = cache["layers"]
    return layers[name][0] if isinstance(layers, dict) else layers[0][name]


def test_sequence_sharded_decode_matches_reference(decode_and_restore):
    cases, _, res = decode_and_restore
    for i, (_, logits, new) in enumerate(cases):
        for r in range(WORLD):
            got = res[r]["decode"][i]
            # the cache stays sequence-sharded over the model axis
            assert "Shard(dim=1)" in got["placements"][0]
            np.testing.assert_allclose(got["logits"], logits, rtol=DECODE_TOL, atol=DECODE_TOL)
            np.testing.assert_allclose(got["k0"], _layer0(new, "k"), rtol=DECODE_TOL,
                                       atol=DECODE_TOL)
            np.testing.assert_array_equal(got["pos0"], _layer0(new, "pos"))
            np.testing.assert_array_equal(got["len"], new["len"])


def test_elastic_restore_from_one_rank_onto_2x2(decode_and_restore):
    from torch.utils import _pytree as pytree

    _, state, res = decode_and_restore
    want = {pytree.keystr(k): v.numpy() for k, v in pytree.tree_flatten_with_path(state)[0]}
    for r in range(WORLD):
        got = dict(res[r]["restore"]["leaves"])
        assert set(got) == set(want)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype and np.array_equal(got[name], arr), name
        # the restored leaves are shards: something is split over each axis
        placed = " ".join(res[r]["restore"]["placements"])
        assert "Shard" in placed
