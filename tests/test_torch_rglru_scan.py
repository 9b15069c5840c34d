"""Kernel B7's plain version (the path CPU tensors take through
``repro_torch::rglru_scan``) against the JAX package: its pure-jnp oracle
``rglru_scan_ref`` with a non-zero starting state, its Pallas kernel in
interpret mode (which starts from zero, as its own tests run it on the
CPU), and the chunked recurrence the reference's models run, on the same
numpy inputs.  Tolerance 2e-5 in f32, as ``tests/test_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro.models.layers import linear_recurrence_chunked
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_cuda, rglru_scan_plain
from repro_torch.models.layers import linear_recurrence

TOL = 2e-5


def _inputs(B, S, R, seed, h0=True):
    """The reference tests' distributions: decay in [0.5, 0.999), inputs
    N(0, 0.1), h0 N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32)
    b = (rng.standard_normal((B, S, R)) * 0.1).astype(np.float32)
    h = rng.standard_normal((B, R)).astype(np.float32) if h0 else None
    return a, b, h


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,R", [(2, 37, 200), (8, 1, 64), (1, 130, 3), (3, 5, 1)])
def test_plain_matches_ref_from_a_nonzero_state(B, S, R):
    a, b, h0 = _inputs(B, S, R, seed=B * S + R)
    hs, h = rglru_scan_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    rhs, rh = rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert hs.dtype == h.dtype == torch.float32
    assert tuple(hs.shape) == (B, S, R) and tuple(h.shape) == (B, R)
    _close(hs, rhs)
    _close(h, rh)


# (B, S, R, block_r, block_s) of tests/test_kernels.py::test_rglru_scan
@pytest.mark.parametrize("B,S,R,br,bs", [(2, 256, 128, 64, 64), (1, 128, 64, 64, 32)])
def test_plain_matches_pallas_kernel_from_zero(B, S, R, br, bs):
    a, b, _ = _inputs(B, S, R, seed=7)
    khs, kh = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_r=br, block_s=bs,
                           interpret=True)
    hs, h = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))     # no h0: zero
    _close(hs, khs)
    _close(h, kh)


def test_state_carries_across_the_pallas_kernels_chunks():
    """Decay 0.999 and one input at t = 0: the state at the end is the
    first input decayed S-1 times, across the Pallas kernel's chunks."""
    B, S, R = 1, 128, 8
    a = np.full((B, S, R), 0.999, np.float32)
    b = np.zeros((B, S, R), np.float32)
    b[:, 0] = 1.0
    hs, h = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), 0.999 ** (S - 1), rtol=1e-4)
    khs, kh = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_r=8, block_s=16,
                           interpret=True)
    _close(hs, khs)
    _close(h, kh)


@pytest.mark.parametrize("tail", [(64,), (6, 4)])
def test_linear_recurrence_matches_the_models_chunked_scan(tail):
    """``layers.linear_recurrence`` (B7's op over flattened trailing axes)
    == the reference's ``linear_recurrence_chunked``, from zero and from a
    state (``tests/test_kernels.py::test_rglru_matches_model_recurrence``)."""
    B, S = 2, 128
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 0.999, (B, S) + tail).astype(np.float32)
    b = (rng.standard_normal((B, S) + tail) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B,) + tail).astype(np.float32)
    for init in (np.zeros_like(h0), h0):
        rhs, rh = linear_recurrence_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(init),
                                            chunk=64)
        hs, h = linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(init))
        assert tuple(hs.shape) == (B, S) + tail and tuple(h.shape) == (B,) + tail
        _close(hs, rhs)
        _close(h, rh)


def test_one_step_from_the_cache_is_the_decode_update():
    """S = 1 from a cached state is the reference's decode update
    ``h = a·h + b``, bit for bit."""
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(8, 1, 40, seed=5))
    hs, h = rglru_scan(a, b, h0)
    assert torch.equal(h, a[:, 0] * h0 + b[:, 0]) and torch.equal(hs[:, 0], h)


def test_custom_op_on_cpu_is_the_plain_version():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(2, 7, 33, seed=9))
    before = rglru_scan_cuda.launches
    hs, h = rglru_scan(a, b, h0)
    assert rglru_scan_cuda.launches == before            # the CPU never counts a launch
    phs, ph = rglru_scan_plain(a, b, h0)
    assert torch.equal(hs, phs) and torch.equal(h, ph)
    hs2, _ = rglru_scan(a.transpose(0, 2).contiguous().transpose(0, 2), b, h0)
    assert torch.equal(hs2, phs)
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_scan_cuda(a, b, h0)
    with pytest.raises(ValueError, match=r"\[B, R\]"):
        rglru_scan(a, b, h0[:, :5])


def test_fake_op_gives_the_output_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty((3, 9, 20))
        hs, h = torch.ops.repro_torch.rglru_scan(a, a, None)
    assert (tuple(hs.shape), hs.dtype) == ((3, 9, 20), torch.float32)
    assert (tuple(h.shape), h.dtype) == ((3, 20), torch.float32)
