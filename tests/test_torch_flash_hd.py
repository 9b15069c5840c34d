"""B3 (flash attention) and B3-bwd at head dims outside the kernels'
instantiated widths 16 / 32 / 64 / 128 / 256: h2o-danube3-4b's 120, and
widths that are not a multiple of 8 (60, 7), which take the CUDA-core form
in every dtype.

On the CPU the plain versions run: ``flash_attention_plain`` against the
JAX package's Pallas kernel (interpret mode) and its ``ref.py``, and
``flash_attention_bwd_plain`` against ``jax.vjp`` of
``models/layers.py::chunked_attention``; the scale stays the true
hd^-0.5.  The choice of form and padded width is pure Python, and the
wrapper's checks run before any device is touched.  Tolerances: 2e-5 in
f32 (the two sum in other orders), 3e-2 in bf16 (the reference rounds the
scaled query, scores and probabilities to bf16 inside its forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import chunked_attention as j_chunked_attention
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_path,
                                                 flash_attention_bwd_plain, flash_attention_cuda,
                                                 flash_attention_path, flash_attention_plain,
                                                 flash_padded_hd)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import _plain_forward

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HDS = (120, 60, 7)


def _inputs(B, S, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, Hq, hd))]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# -- form and padded width -------------------------------------------------------

@pytest.mark.parametrize("hd,width", [(1, 16), (7, 16), (16, 16), (17, 32), (60, 64),
                                      (64, 64), (72, 128), (120, 128), (128, 128),
                                      (200, 256), (256, 256)])
def test_padded_width_is_the_least_instantiated_width_that_holds_hd(hd, width):
    assert flash_padded_hd(hd) == width


@pytest.mark.parametrize("hd", [0, -8, 257, 512])
def test_padded_width_refuses_what_no_width_holds(hd):
    with pytest.raises(ValueError, match="head dim"):
        flash_padded_hd(hd)


@pytest.mark.parametrize("dtype,hd,form", [
    (torch.bfloat16, 120, "mma"), (torch.float16, 120, "mma"), (torch.bfloat16, 72, "mma"),
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, None, "mma"), (torch.bfloat16, 60, "simt"),
    (torch.float16, 7, "simt"), (torch.float32, 120, "simt"), (torch.float32, 256, "simt")])
def test_form_needs_16_byte_rows_for_the_tensor_cores(dtype, hd, form):
    assert flash_attention_path(dtype, hd) == form
    assert flash_attention_bwd_path(dtype, hd) == form


@pytest.mark.parametrize("hd", [1, 7, 60, 120, 200, 256])
def test_wrapper_takes_every_head_dim_up_to_256(monkeypatch, hd):
    """The shape checks pass at any hd of 1 .. 256 and the wrapper stops
    only at the device (no kernel is built or launched for a CPU tensor)."""
    monkeypatch.setattr(ops, "_lib", lambda: pytest.fail("reached the kernel"))
    monkeypatch.setattr(ops, "_bwd_lib", lambda: pytest.fail("reached the kernel"))
    q = torch.zeros((1, 5, 4, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 5, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_cuda(q, k, k, True, None, 0)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_bwd_cuda(q, q, k, k, q, torch.zeros((1, 4, 5)), True, None, 0)


@pytest.mark.parametrize("hd", [0, 257])
def test_wrapper_refuses_head_dims_outside_1_to_256(hd):
    q = torch.zeros((1, 5, 4, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 5, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd in 1..256"):
        flash_attention_cuda(q, k, k, True, None, 0)


# -- the plain forward against the reference -----------------------------------------

@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HDS)
def test_plain_forward_matches_the_pallas_kernel(hd, dtype, window):
    q, k, v, _ = _inputs(2, 32, 4, 2, hd, seed=hd)
    ref = j_flash_kernel(*(jnp.asarray(a).astype(J_DT[dtype]) for a in (q, k, v)),
                         causal=True, window=window, block_q=16, block_k=8, interpret=True)
    out = flash_attention_plain(*(torch.from_numpy(a).to(T_DT[dtype]) for a in (q, k, v)),
                                True, window, 0, 8, 16)
    _close(out, ref, dtype)


@pytest.mark.parametrize("hd", HDS)
def test_plain_forward_matches_attention_ref(hd):
    """Ragged lengths, a query block that starts mid-sequence and a window."""
    rng = np.random.default_rng(hd + 1)
    q = rng.standard_normal((2, 24, 4, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, hd)).astype(np.float32) for _ in range(2))
    ref = attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=11,
                        q_offset=16)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), True, 11, 16, 8, 8)
    _close(out, ref, "float32")


# -- the plain backward against jax.vjp ------------------------------------------------

@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HDS)
def test_plain_backward_matches_jax_vjp(hd, dtype, window):
    arrays = _inputs(2, 24, 8, 2, hd, seed=3 * hd)
    q, k, v, do = (jnp.asarray(a).astype(J_DT[dtype]) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: j_chunked_attention(
        q, k, v, causal=True, window=window, chunk=8, q_chunk=8), q, k, v)
    want = vjp(do)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(T_DT[dtype]) for a in arrays)
    tout, lse = _plain_forward(tq, tk, tv, True, window, 0, 8, 8)
    _close(tout, out, dtype)
    grads = flash_attention_bwd_plain(tdo, tq, tk, tv, tout, lse, True, window, 0)
    for got, w, t in zip(grads, want, (tq, tk, tv)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, w, dtype)
