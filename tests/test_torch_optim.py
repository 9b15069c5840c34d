"""The port's optimizer against the JAX package's, on the same numpy arrays:
the learning-rate schedules, the global norm, and AdamW's update (clip,
moments, bias correction, the decay mask) with f32 and bf16 parameters.

Tolerances: f32 results within 2e-6 relative (the two frameworks' f32
``pow`` / ``sqrt`` / sums may round their last bit differently); a bf16
parameter may then round to the neighbouring bf16 value, so bf16 params
compare within one bf16 ulp (at most 2^-7 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                               global_norm, linear_warmup_cosine)

J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 500, 1000, 2000])
def test_schedules_match_reference(step):
    s = np.int32(step)
    want = jschedule.linear_warmup_cosine(jnp.asarray(s), 3e-3, 100, 1000)
    got = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-3, 100, 1000)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    want = jschedule.cosine_schedule(jnp.asarray(s), 1e-3, 700, min_frac=0.2)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), 1e-3, 700, min_frac=0.2)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)


def _tree(rng, dtype):
    """A param-dict shaped like a model's: decayed matrices, and leaves the
    mask spares (norm gains, a bias named ``b``, ``final_norm``)."""
    def a(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return {"embed": a(16, 8), "final_norm": a(8),
            "layers": [{"ln1": a(8), "attn": {"wq": a(8, 8), "wo": a(8, 8)},
                        "mlp": {"w_up": a(8, 12), "b": a(12)}} for _ in range(2)]}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(J_DT[dtype]), tree)


def _to_torch(tree, dtype):
    return torch.utils._pytree.tree_map(lambda x: torch.from_numpy(x.copy()).to(T_DT[dtype]),
                                        tree, is_leaf=lambda x: isinstance(x, np.ndarray))


def _compare(got, want, dtype):
    # the port keeps dict insertion order, JAX sorts keys: compare by path
    gp = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(torch.utils._pytree.tree_map(
              lambda t: t.detach().float().numpy(), got))[0]}
    wp = {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    assert gp.keys() == wp.keys()
    rtol = 2 ** -7 if dtype == "bfloat16" else 2e-6
    for k in gp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=rtol, atol=1e-7, err_msg=k)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng, "float32")
    want = jadamw.global_norm(_to_jax(tree, "float32"))
    got = global_norm(_to_torch(tree, "float32"))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_matches_reference(dtype, clip, weight_decay):
    """Three updates from the same params and grads (the second and third
    from carried moments), through both packages; the clip either bites
    (1.0) or not (1e3)."""
    rng = np.random.default_rng(1)
    params = _tree(rng, dtype)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=weight_decay, clip_norm=clip)
    tcfg = AdamWConfig(lr=1e-2, weight_decay=weight_decay, clip_norm=clip)
    jp, tp = _to_jax(params, dtype), _to_torch(params, dtype)
    jst, tst = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for it in range(3):
        grads = _tree(rng, dtype)
        lr = 1e-2 * (it + 1) / 3
        jp, jst, jm = jadamw.adamw_update(_to_jax(grads, dtype), jp, jst, jcfg, lr=lr)
        tp, tst, tm = adamw_update(_to_torch(grads, dtype), tp, tst, tcfg,
                                   lr=torch.tensor(lr))
        assert int(tst["step"]) == int(jst["step"]) == it + 1
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-6)
        np.testing.assert_allclose(tm["clip_scale"].item(), float(jm["clip_scale"]), rtol=2e-6)
        _compare(tst["m"], jst["m"], "float32")
        _compare(tst["v"], jst["v"], "float32")
        _compare(tp, jp, dtype)
    assert all(t.dtype == T_DT[dtype] for t in torch.utils._pytree.tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in torch.utils._pytree.tree_leaves(tst["m"]))


def test_decay_mask_spares_norms_and_biases():
    """With zero gradients only decoupled decay moves a parameter: the
    matrices shrink by lr * wd * p, the norm gains and biases do not."""
    rng = np.random.default_rng(2)
    tp = _to_torch(_tree(rng, "float32"), "float32")
    before = torch.utils._pytree.tree_map(torch.clone, tp)
    zeros = torch.utils._pytree.tree_map(torch.zeros_like, tp)
    adamw_update(zeros, tp, adamw_init(tp), AdamWConfig(lr=0.5, weight_decay=0.1))
    for name in ("final_norm",):
        assert torch.equal(tp[name], before[name])
    assert torch.allclose(tp["embed"], before["embed"] * (1 - 0.05))
    for lp, lb in zip(tp["layers"], before["layers"]):
        assert torch.equal(lp["ln1"], lb["ln1"]) and torch.equal(lp["mlp"]["b"], lb["mlp"]["b"])
        assert torch.allclose(lp["attn"]["wq"], lb["attn"]["wq"] * (1 - 0.05))


def test_adamw_updates_in_place():
    rng = np.random.default_rng(3)
    tp = _to_torch(_tree(rng, "float32"), "float32")
    st = adamw_init(tp)
    ids = [id(t) for t in torch.utils._pytree.tree_leaves((tp, st["m"], st["v"]))]
    new_p, new_st, _ = adamw_update(_to_torch(_tree(rng, "float32"), "float32"), tp, st)
    assert [id(t) for t in torch.utils._pytree.tree_leaves(
        (new_p, new_st["m"], new_st["v"]))] == ids
    assert int(new_st["step"]) == 1 and int(st["step"]) == 0
