"""B4's backward against the JAX package's gradients: ``jax.grad`` through
``repro.core.wavefront``'s LSTM cell, its sequential interpreter and its
stacked wavefront plan (XLA's autodiff; the JAX package has no backward
kernel), on the same numpy inputs.  On a CPU tensor autograd reaches
``repro_torch::lstm_cell_bwd``'s plain version, which is what these hold to
the reference.  The twin of ``tests/test_core_wavefront.py::
test_stacked_jit_and_grad``, compared with JAX's values rather than only
checked for finite ones.  Tolerance 2e-5 in f32 (the sums run in other
orders); bf16 gates within 3e-2, as ``tests/test_kernels.py`` takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wavefront as jw
from repro_torch.core import wavefront as tw
from repro_torch.kernels.lstm_cell import lstm_cell_bwd_plain, lstm_cell_fused, lstm_cell_plain

TOL = 2e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,D,H", [(3, 8, 8), (4, 16, 32), (2, 5, 12)])
def test_cell_gradient_matches_jax_grad(B, D, H):
    rng = np.random.default_rng(B + D + H)
    arrs = {"Wx": rng.standard_normal((D, 4 * H)) * 0.3,
            "Wh": rng.standard_normal((H, 4 * H)) * 0.3,
            "b": rng.standard_normal(4 * H) * 0.3, "x": rng.standard_normal((B, D)),
            "h": rng.standard_normal((B, H)), "c": rng.standard_normal((B, H)),
            "wh": rng.standard_normal((B, H)), "wc": rng.standard_normal((B, H))}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    names = ("Wx", "Wh", "b", "x", "h", "c")

    def jloss(Wx, Wh, b, x, h, c):
        hn, cn = jw.lstm_cell({"Wx": Wx, "Wh": Wh, "b": b}, x, h, c)
        return jnp.sum(hn * arrs["wh"]) + jnp.sum(cn * arrs["wc"])

    want = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(arrs[n]) for n in names))
    t = {n: torch.from_numpy(arrs[n]).requires_grad_(True) for n in names}
    hn, cn = tw.lstm_cell({"Wx": t["Wx"], "Wh": t["Wh"], "b": t["b"]}, t["x"], t["h"], t["c"])
    loss = (hn * torch.from_numpy(arrs["wh"])).sum() + (cn * torch.from_numpy(arrs["wc"])).sum()
    for n, g, w in zip(names, torch.autograd.grad(loss, [t[n] for n in names]), want):
        _close(g, w)


@pytest.mark.parametrize("gates,state", [(torch.float32, torch.float32),
                                         (torch.bfloat16, torch.float32),
                                         (torch.bfloat16, torch.bfloat16)])
def test_plain_backward_is_autograd_of_the_plain_forward(gates, state):
    """``lstm_cell_bwd_plain`` against autograd through ``lstm_cell_plain``
    (both in f32 arithmetic on the same rounded inputs), each output in its
    input's dtype; the op's registered gradient gives the same."""
    rng = np.random.default_rng(7)
    N, H = 6, 10
    gx, gh = (torch.as_tensor(rng.standard_normal((N, 4 * H)), dtype=gates) for _ in range(2))
    b = torch.as_tensor(rng.standard_normal(4 * H), dtype=gates)
    c = torch.as_tensor(rng.standard_normal((N, H)), dtype=state)
    dh = torch.as_tensor(rng.standard_normal((N, H)), dtype=gates)
    dc = torch.as_tensor(rng.standard_normal((N, H)), dtype=state)
    dg, dcp = lstm_cell_bwd_plain(gx, gh, b, c, dh, dc)
    assert dg.dtype == gates and dcp.dtype == state
    ins = [t.float().requires_grad_(True) for t in (gx, gh, b, c)]
    h, cn = lstm_cell_plain(*ins)
    want = torch.autograd.grad((h, cn), ins, (dh.float(), dc.float()))
    tol = 2e-5 if gates == state == torch.float32 else 3e-2
    for w in want[:2]:                      # the gradient of gx and of gh
        torch.testing.assert_close(dg.float(), w, atol=tol, rtol=tol)
    torch.testing.assert_close(dg.float().sum(0), want[2], atol=tol, rtol=tol)
    torch.testing.assert_close(dcp.float(), want[3], atol=tol, rtol=tol)
    ins2 = [t.clone().requires_grad_(True) for t in (gx, gh, b, c)]
    h2, c2 = lstm_cell_fused(*ins2)
    got = torch.autograd.grad((h2, c2), ins2, (dh, dc))
    assert torch.equal(got[0], dg) and torch.equal(got[1], dg) and torch.equal(got[3], dcp)
    assert torch.equal(got[2], dg.float().sum(0).to(b.dtype))


def _stacked(L, H, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(shape) * 0.1).astype(np.float32)
            for k, shape in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)), ("b", (L, 4 * H)))}


@pytest.mark.parametrize("L,T,B,H", [(3, 4, 2, 8), (2, 6, 3, 16), (4, 3, 1, 8)])
def test_stacked_and_sequential_gradients_match_jax_grad(L, T, B, H):
    """d sum(out^2) / d(params, xs) through the stacked wavefront plan and
    the sequential interpreter, against ``jax.grad`` of the reference's
    stacked plan (test_stacked_jit_and_grad's loss)."""
    p = _stacked(L, H, seed=L * 10 + T)
    xs = np.random.default_rng(T).standard_normal((T, B, H)).astype(np.float32)

    def jloss(params, xs):
        return jnp.sum(jw.stacked_wavefront_lstm(params, xs, L) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                              jnp.asarray(xs))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(xs).requires_grad_(True)
    out = tw.stacked_wavefront_lstm(tp, tx, L)
    g = torch.autograd.grad((out ** 2).sum(), [tp["Wx"], tp["Wh"], tp["b"], tx])
    for got, want in zip(g, (jg["Wx"], jg["Wh"], jg["b"], jgx)):
        _close(got, want)

    per_layer = [{k: torch.from_numpy(v[l].copy()).requires_grad_(True) for k, v in p.items()}
                 for l in range(L)]
    tx2 = torch.from_numpy(xs).requires_grad_(True)
    out = tw.sequential_lstm(per_layer, tx2)
    leaves = [lp[k] for lp in per_layer for k in ("Wx", "Wh", "b")]
    g = torch.autograd.grad((out ** 2).sum(), leaves + [tx2])
    for l in range(L):
        for j, k in enumerate(("Wx", "Wh", "b")):
            _close(g[3 * l + j], np.asarray(jg[k])[l])
    _close(g[-1], jgx)
