"""The port's data pipeline and checkpoint store, against the JAX package's.

Data: the port keeps its own numpy copy of the pipeline, so its batches
must equal the reference's exactly, step by step and host slice by host
slice; the determinism, sharding and prefetch contract of
``tests/test_data_checkpoint.py`` holds for it too.  Checkpoints: the same
on-disk layout, so a state written by either package restores in the
other bit for bit, bf16 included (no ``ml_dtypes`` on the port's side),
plus the store's own contract (atomic publish, keep-N, missing leaves,
async save, dtype casts).
"""
import logging
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import restore_state as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                                    restore_state, save_checkpoint)
from repro_torch.checkpoint.store import list_steps
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokens, make_pipeline


def _src(**kw):
    base = dict(vocab_size=128, seq_len=32, global_batch=8, seed=11)
    base.update(kw)
    return SyntheticTokens(DataConfig(**base))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bigram", "uniform", "copy"])
@pytest.mark.parametrize("seed", [0, 11])
def test_batches_equal_the_reference(kind, seed):
    kw = dict(vocab_size=300, seq_len=24, global_batch=4, seed=seed, kind=kind)
    ours, ref = SyntheticTokens(DataConfig(**kw)), JSyntheticTokens(JDataConfig(**kw))
    for step in (0, 1, 5, 12345):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for h in range(2):
        a, b = ours.host_batch(3, h, 2), ref.host_batch(3, h, 2)
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_batches_deterministic_by_step():
    a, b = _src(), _src()
    for step in (0, 1, 17, 100_000):
        x, y = a.batch(step), b.batch(step)
        assert np.array_equal(x["tokens"], y["tokens"])
        assert np.array_equal(x["labels"], y["labels"])


def test_labels_are_next_tokens():
    b = _src().batch(3)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_slicing_partitions_global_batch():
    s = _src()
    g = s.batch(5)["tokens"]
    parts = [s.host_batch(5, h, 4)["tokens"] for h in range(4)]
    assert np.array_equal(np.concatenate(parts), g)
    with pytest.raises(ValueError, match="not divisible"):
        s.host_batch(5, 0, 3)


def test_bigram_structure_learnable():
    """Successor of token t equals table[t] ~90% of the time."""
    s = _src(seq_len=256, global_batch=16)
    b = s.batch(0)["tokens"]
    hits = (s._table[b[:, :-1]] == b[:, 1:]).mean()
    assert 0.8 < hits < 0.97, hits


def test_prefetcher_matches_direct_and_handles_restart():
    src = _src()
    pf = make_pipeline(src.cfg, start_step=0, prefetch=3)
    try:
        for i in range(5):
            assert np.array_equal(pf.get(i)["tokens"], src.batch(i)["tokens"])
        # simulate restart: jump back
        assert np.array_equal(pf.get(2)["tokens"], src.batch(2)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_names_stuck_stage(caplog):
    """A producer wedged inside its generator cannot be interrupted, but
    close() names the stage it is stuck in."""
    release, wedged = threading.Event(), threading.Event()
    producer = None

    class WedgedSource:
        def __init__(self):
            self.cfg = DataConfig(vocab_size=7, seq_len=4, global_batch=2)

        def batch(self, step):
            if step > 0 and threading.current_thread() is producer:
                wedged.set()
                release.wait(30)
            return SyntheticTokens(self.cfg).batch(step)

    pf = Prefetcher(WedgedSource(), start_step=0, depth=1)
    producer = pf._thread
    try:
        pf.get(0)
        assert wedged.wait(10), "producer never reached the wedge"
        with caplog.at_level(logging.WARNING, logger="repro_torch.data.pipeline"):
            pf.close(timeout=0.3)
        stuck = [r for r in caplog.records if "stuck in" in r.message]
        assert stuck and "generate(step=" in stuck[0].message
    finally:
        release.set()
        pf._thread.join(timeout=5)
        assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _state():
    """A train state of the port's layout: bf16 params in a per-layer list,
    f32 moments, an int32 step."""
    w = torch.arange(12.0).reshape(3, 4) / 7
    return {
        "params": {"w": w.bfloat16(), "layers": [{"a": torch.ones(5).bfloat16() / 3},
                                                 {"a": -torch.arange(2.0).bfloat16()}]},
        "m": {"w": torch.full((3, 4), 0.5), "layers": [{"a": torch.ones(5) * 2},
                                                      {"a": torch.ones(2)}]},
        "step": torch.tensor(9, dtype=torch.int32),
    }


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _same(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def test_roundtrip_exact():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 42, s)
        step, flat = load_checkpoint(d)
        assert step == 42
        assert _same(restore_state(s, flat), s)


def test_port_checkpoint_restores_in_the_reference_bit_for_bit():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, s)
        step, flat = j_load(d)
        assert step == 3 and str(flat["params/w"].dtype) == "bfloat16"
        jtmpl = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.dtype(str(t.dtype)[6:])),
                             pytree.tree_map(lambda t: t, s),
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
        out = j_restore(jtmpl, flat)
    for (path, leaf) in pytree.tree_flatten_with_path(s)[0]:
        j = out
        for p in path:
            j = j[p.key if hasattr(p, "key") else p.idx]
        want = leaf.float().numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        assert np.array_equal(np.asarray(j).astype(want.dtype), want)
        if leaf.dtype == torch.bfloat16:
            assert np.array_equal(np.asarray(j).view(np.uint16), leaf.view(torch.int16).numpy()
                                  .view(np.uint16))


def test_reference_checkpoint_restores_in_the_port_bit_for_bit():
    """A state the JAX package saved (per-layer list layout, bf16 through
    ml_dtypes) restores into the port's state, every bit."""
    rng = np.random.default_rng(0)
    jstate = {"params": {"w": jnp.asarray(rng.standard_normal((3, 4))).astype(jnp.bfloat16),
                         "layers": [{"a": jnp.asarray(rng.standard_normal(5)).astype(
                             jnp.bfloat16)} for _ in range(2)]},
              "m": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32)},
              "step": jnp.asarray(7, jnp.int32)}
    tmpl = {"params": {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
                       "layers": [{"a": torch.zeros(5, dtype=torch.bfloat16)} for _ in range(2)]},
            "m": {"w": torch.zeros((3, 4))}, "step": torch.tensor(0, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        j_save(d, 5, jstate)
        step, flat = load_checkpoint(d)
        out = restore_state(tmpl, flat)
    assert step == 5 and int(out["step"]) == 7
    for got, want in ((out["params"]["w"], jstate["params"]["w"]),
                      (out["params"]["layers"][1]["a"], jstate["params"]["layers"][1]["a"])):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16))
    assert np.array_equal(out["m"]["w"].numpy(), np.asarray(jstate["m"]["w"]))


def test_keep_n_prunes_old():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        for i in range(5):
            save_checkpoint(d, i, s, keep=2)
        assert list_steps(d) == [3, 4]


def test_crash_mid_save_never_corrupts_latest():
    """A .tmp dir left by a 'crashed' save is invisible to restore."""
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, s)
        os.makedirs(os.path.join(d, "step_00000002.tmp"))
        with open(os.path.join(d, "step_00000002.tmp", "state.npz"), "w") as f:
            f.write("garbage")
        assert latest_step(d) == 1
        step, flat = load_checkpoint(d)
        assert step == 1 and "step" in flat


def test_missing_leaf_raises():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 0, s)
        _, flat = load_checkpoint(d)
        del flat["params/w"]
        with pytest.raises(KeyError):
            restore_state(s, flat)


def test_manager_async_save_snapshots_and_restores():
    """The manager copies the state before its thread writes it: an
    in-place update right after ``save`` does not reach the checkpoint."""
    s = _state()
    want = pytree.tree_map(torch.clone, s)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_save=True)
        mgr.save(10, s)
        s["m"]["w"].add_(1.0)
        mgr.wait()
        step, out = mgr.restore(want)
        assert step == 10 and mgr.latest() == 10
        assert _same(out, want)


def test_restore_casts_to_template_dtype():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 0, s)
        _, flat = load_checkpoint(d)
        tmpl = pytree.tree_map(lambda x: x.double() if x.is_floating_point() else x, s)
        out = restore_state(tmpl, flat)
    assert out["params"]["w"].dtype == torch.float64
    assert torch.equal(out["params"]["w"], s["params"]["w"].double())
