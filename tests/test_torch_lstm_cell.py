"""Kernel B4's plain version (the path CPU tensors take through
``repro_torch::lstm_cell``) against the JAX package's Pallas kernel (run in
interpret mode, as its own tests run it on the CPU) and its pure-jnp oracle,
on the same numpy inputs.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 in f32 and 3e-2 where anything is bf16 (the two frameworks round
transcendentals at other places)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell import lstm_cell_fused as j_lstm_cell_fused
from repro.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.lstm_cell import lstm_cell_cuda, lstm_cell_fused, lstm_cell_plain

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _tol(*dts):
    return 3e-2 if "bf16" in dts else 2e-5


def _inputs(N, H, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((N, 4 * H), (N, 4 * H), (4 * H,), (N, H))]


def _both(arrays, dts):
    """The same arrays in both frameworks, each cast to its dtype (f32 ->
    bf16 rounds to nearest even in both, so they start from the same bits)."""
    j = [jnp.asarray(a).astype(JAX_DT[d]) for a, d in zip(arrays, dts)]
    t = [torch.from_numpy(a).to(TORCH_DT[d]) for a, d in zip(arrays, dts)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# (N, H, bn, bh) of tests/test_kernels.py::test_lstm_cell
CASES = [(64, 128, 32, 64), (32, 256, 32, 128), (128, 64, 64, 64)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,H,bn,bh", CASES)
def test_plain_matches_pallas_kernel_and_ref(N, H, bn, bh, dt):
    (jgx, jgh, jb, jc), (gx, gh, b, c) = _both(_inputs(N, H, seed=N + H), [dt] * 4)
    h, c_new = lstm_cell_plain(gx, gh, b, c)
    assert h.dtype == TORCH_DT[dt] and c_new.dtype == TORCH_DT[dt]
    kh, kc = j_lstm_cell_fused(jgx, jgh, jb, jc, block_n=bn, block_h=bh, interpret=True)
    rh, rc = lstm_cell_ref(jgx, jgh, jb, jc)
    for got, want in ((h, kh), (c_new, kc), (h, rh), (c_new, rc)):
        _close(got, want, _tol(dt))


@pytest.mark.parametrize("dts", [("bf16", "bf16", "bf16", "f32"), ("bf16", "bf16", "f32", "f32"),
                                 ("f32", "f32", "f32", "bf16")])
def test_mixed_dtypes_keep_the_state_dtype(dts):
    """h takes the gates' dtype, c' the state's: a bf16 run keeps f32 state."""
    N, H = 32, 64
    (jgx, jgh, jb, jc), (gx, gh, b, c) = _both(_inputs(N, H, seed=3), dts)
    h, c_new = lstm_cell_plain(gx, gh, b, c)
    assert h.dtype == TORCH_DT[dts[0]] and c_new.dtype == TORCH_DT[dts[3]]
    kh, kc = j_lstm_cell_fused(jgx, jgh, jb, jc, block_n=32, block_h=64, interpret=True)
    rh, rc = lstm_cell_ref(jgx, jgh, jb, jc)
    assert kh.dtype == JAX_DT[dts[0]] and kc.dtype == JAX_DT[dts[3]]
    for got, want in ((h, kh), (c_new, kc), (h, rh), (c_new, rc)):
        _close(got, want, _tol(*dts))


def test_kernel_math_matches_the_wavefront_cell():
    """B4 on the two products == the LSTM cell of both packages
    (``tests/test_kernels.py::test_lstm_cell_matches_wavefront_cell``)."""
    from repro.core.wavefront import lstm_cell as j_cell
    from repro_torch.core.wavefront import lstm_cell as t_cell

    B, D, H = 8, 32, 32
    rng = np.random.default_rng(5)
    p = {"Wx": rng.standard_normal((D, 4 * H)) * 0.1, "Wh": rng.standard_normal((H, 4 * H)) * 0.1,
         "b": rng.standard_normal(4 * H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x, h = (rng.standard_normal((B, n)).astype(np.float32) for n in (D, H))
    c = np.zeros((B, H), np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx, th, tc = (torch.from_numpy(a) for a in (x, h, c))
    k_h, k_c = lstm_cell_plain(tx @ tp["Wx"], th @ tp["Wh"], tp["b"], tc)
    t_h, t_c = t_cell(tp, tx, th, tc)
    r_h, r_c = j_cell({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(h),
                      jnp.asarray(c))
    assert torch.equal(k_h, t_h) and torch.equal(k_c, t_c)
    _close(t_h, r_h, 2e-5)
    _close(t_c, r_c, 2e-5)


def test_custom_op_on_cpu_is_the_plain_version():
    gx, gh, b, c = (torch.from_numpy(a) for a in _inputs(5, 12, seed=9))
    before = lstm_cell_cuda.launches
    h, c_new = lstm_cell_fused(gx, gh, b, c)
    assert lstm_cell_cuda.launches == before          # the CPU never counts a launch
    ph, pc = lstm_cell_plain(gx, gh, b, c)
    assert torch.equal(h, ph) and torch.equal(c_new, pc)
    # a strided view goes through .contiguous() first
    h2, _ = lstm_cell_fused(gx.t().contiguous().t(), gh, b, c)
    assert torch.equal(h2, ph)


def test_fake_op_gives_the_output_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        gx = torch.empty((6, 40), dtype=torch.bfloat16)
        h, c_new = torch.ops.repro_torch.lstm_cell(gx, gx, torch.empty(40),
                                                   torch.empty((6, 10)))
    assert (h.shape, h.dtype) == ((6, 10), torch.bfloat16)
    assert (c_new.shape, c_new.dtype) == ((6, 10), torch.float32)


def test_cuda_wrapper_refuses_cpu_tensors():
    gx, gh, b, c = (torch.from_numpy(a) for a in _inputs(2, 4, seed=1))
    with pytest.raises(ValueError, match="needs CUDA"):
        lstm_cell_cuda(gx, gh, b, c)


def test_backward_is_not_registered():
    """The op's backward is registered since kernel B4 got one (the name is
    kept from before, when a gradient raised): on a CPU tensor it is
    ``lstm_cell_bwd_plain``, and it agrees with autograd through the plain
    forward within 2e-5 (f32)."""
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_plain

    gx, gh, b, c = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(2, 4, seed=2))
    h, c_new = lstm_cell_fused(gx, gh, b, c)
    dh, dc = torch.ones_like(h), torch.full_like(c_new, 0.5)
    got = torch.autograd.grad((h, c_new), (gx, gh, b, c), (dh, dc))
    dg, dcp = lstm_cell_bwd_plain(gx, gh, b, c, dh, dc)
    assert torch.equal(got[0], dg) and torch.equal(got[1], dg) and torch.equal(got[3], dcp)
    h2, c2 = lstm_cell_plain(gx, gh, b, c)
    want = torch.autograd.grad((h2, c2), (gx, gh, b, c), (dh, dc))
    for g, w in zip(got, want):
        _close(g, w.detach().numpy(), _tol("f32"))
