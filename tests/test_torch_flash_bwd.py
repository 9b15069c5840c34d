"""B3's backward against the JAX package's gradient of the same attention:
``jax.vjp`` of ``repro.models.layers.chunked_attention`` (XLA's autodiff;
the JAX package has no backward kernel) on the same numpy inputs and the
same output cotangent.  Both the plain backward (what a CPU tensor takes
inside ``repro_torch::flash_attention_bwd``) and autograd through the
training op ``repro_torch::flash_attention_train`` are held to it, causal
and windowed, G = 1 / 2 / 4 query heads a KV head, chunks smaller than the
sequence.  Tolerances: 2e-5 in f32 (the two sum in other orders); 3e-2 in
bf16 (the reference rounds the scaled query, scores and probabilities to
bf16 inside its forward, so its gradient carries those roundings; the
port's backward recomputes in f32), as ``tests/test_kernels.py`` takes for
the forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as j_chunked_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd_plain
from repro_torch.kernels.flash_attention.ops import _plain_forward
from repro_torch.models.layers import chunked_attention

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, S, Hq, Hkv, hd, window, chunk, q_chunk)
CASES = [(2, 16, 4, 4, 16, None, 8, 4),      # G = 1
         (2, 24, 4, 2, 16, None, 8, 8),      # G = 2
         (1, 32, 8, 2, 32, 7, 8, 16),        # G = 4, windowed
         (2, 20, 4, 1, 16, 5, 4, 4),         # MQA, a window shorter than a chunk
         (1, 12, 2, 1, 64, None, 2048, 2048)]


def _inputs(B, S, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, Hq, hd))]


def _reference(arrays, dtype, window, chunk, q_chunk):
    q, k, v, do = (jnp.asarray(a).astype(J_DT[dtype]) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: j_chunked_attention(
        q, k, v, causal=True, window=window, chunk=chunk, q_chunk=q_chunk), q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(do))]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,chunk,q_chunk", CASES)
def test_plain_backward_matches_jax_vjp(B, S, Hq, Hkv, hd, window, chunk, q_chunk, dtype):
    arrays = _inputs(B, S, Hq, Hkv, hd, seed=S + hd)
    want = _reference(arrays, dtype, window, chunk, q_chunk)
    q, k, v, do = (torch.from_numpy(a).to(T_DT[dtype]) for a in arrays)
    out, lse = _plain_forward(q, k, v, True, window, 0, chunk, q_chunk)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    grads = flash_attention_bwd_plain(do, q, k, v, out, lse, True, window, 0)
    for got, w, t in zip(grads, want[1:], (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,chunk,q_chunk", CASES)
def test_autograd_through_the_training_op_matches_jax_vjp(B, S, Hq, Hkv, hd, window, chunk,
                                                          q_chunk, dtype):
    arrays = _inputs(B, S, Hq, Hkv, hd, seed=7 * S + hd)
    want = _reference(arrays, dtype, window, chunk, q_chunk)
    q, k, v = (torch.from_numpy(a).to(T_DT[dtype]).requires_grad_(True) for a in arrays[:3])
    do = torch.from_numpy(arrays[3]).to(T_DT[dtype])
    out = chunked_attention(q, k, v, causal=True, window=window, chunk=chunk, q_chunk=q_chunk)
    _close(out, want[0], dtype)
    for got, w in zip(torch.autograd.grad(out, (q, k, v), do), want[1:]):
        _close(got, w, dtype)


def test_training_op_forward_is_the_serving_forward():
    """The training op's output is the serving op's bit for bit, and its
    log-sum-exp is each row's logsumexp of its kept, scaled scores."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 20, 4, 2, 16, seed=3))
    out, lse = torch.ops.repro_torch.flash_attention_train(q, k, v, True, 6, 0, 8, 4)
    assert torch.equal(out, flash_attention(q, k, v, causal=True, window=6, chunk=8,
                                            q_chunk=4))
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 20, 2, 2, 16), k) * 16 ** -0.5
    i = torch.arange(20)
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 6)
    want = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1).reshape(2, 4, 20)
    torch.testing.assert_close(lse, want, atol=2e-6, rtol=2e-6)


def test_serving_path_takes_the_serving_op():
    """Without a gradient being recorded ``chunked_attention`` is the
    serving op, so serving launches and counts are untouched; with one it
    is the training op."""
    from torch.fx.experimental.proxy_tensor import make_fx

    q = torch.zeros((1, 8, 2, 16))
    names = {str(n.target) for n in make_fx(lambda q: chunked_attention(q, q, q))(q).graph.nodes}
    assert "repro_torch.flash_attention.default" in names
    with torch.no_grad():
        qg = q.clone().requires_grad_(True)
        names = {str(n.target) for n in
                 make_fx(lambda q: chunked_attention(q, q, q))(qg).graph.nodes}
    assert "repro_torch.flash_attention.default" in names

    def loss(q):
        q = q.detach().requires_grad_(True)
        out = chunked_attention(q, q, q)
        return torch.autograd.grad(out.sum(), q)[0]
    names = {str(n.target) for n in make_fx(loss)(q).graph.nodes}
    assert {"repro_torch.flash_attention_train.default",
            "repro_torch.flash_attention_bwd.default"} <= names


def test_lse_gets_no_gradient():
    """The log-sum-exp is a residual of the training op, not differentiable:
    asking for its gradient raises rather than returning a wrong one."""
    q = torch.randn((1, 6, 2, 16), requires_grad=True)
    out, lse = torch.ops.repro_torch.flash_attention_train(q, q, q, True, None, 0, 2048, 2048)
    assert not lse.requires_grad and out.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(lse.sum(), q)
