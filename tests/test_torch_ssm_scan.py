"""Kernel B6's plain version (the path CPU tensors take through
``repro_torch::ssm_scan``) against the JAX package: its pure-jnp oracle
``ssm_scan_ref`` with a non-zero starting state, and its Pallas kernel in
interpret mode (which starts from zero, as its own tests run it on the
CPU), on the same numpy inputs.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32 (the reference sums the states of
``y`` in another order; the Pallas kernel runs an associative scan)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_cuda, ssm_scan_plain

TOL = 2e-5


def _inputs(B, S, D, St, seed, h0=True):
    """The reference tests' distributions: decay in [0.5, 0.999), inputs
    N(0, 0.1), c and h0 N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, D, St)).astype(np.float32)
    b = (rng.standard_normal((B, S, D, St)) * 0.1).astype(np.float32)
    c = rng.standard_normal((B, S, St)).astype(np.float32)
    h = rng.standard_normal((B, D, St)).astype(np.float32) if h0 else None
    return a, b, c, h


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,D,St", [(2, 37, 20, 16), (1, 1, 64, 16), (3, 9, 5, 4),
                                      (2, 64, 8, 32), (1, 5, 3, 1)])
def test_plain_matches_ref_from_a_nonzero_state(B, S, D, St):
    a, b, c, h0 = _inputs(B, S, D, St, seed=B * S + D)
    y, h = ssm_scan_plain(*(torch.from_numpy(x) for x in (a, b, c, h0)))
    ry, rh = ssm_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(h0))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, D) and tuple(h.shape) == (B, D, St)
    _close(y, ry)
    _close(h, rh)


# (B, S, D, St, block_d, block_s) of tests/test_kernels.py::test_ssm_scan
@pytest.mark.parametrize("B,S,D,St,bd,bs", [(2, 128, 64, 8, 32, 32), (1, 256, 32, 16, 32, 64)])
def test_plain_matches_pallas_kernel_from_zero(B, S, D, St, bd, bs):
    a, b, c, _ = _inputs(B, S, D, St, seed=6)
    ky, kh = j_ssm_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), block_d=bd,
                        block_s=bs, interpret=True)
    y, h = ssm_scan(*(torch.from_numpy(x) for x in (a, b, c)))   # no h0: zero
    _close(y, ky)
    _close(h, kh)


def test_state_carries_like_the_pallas_kernel():
    """``tests/test_kernels.py::test_ssm_scan_state_carries_across_chunks``:
    decay 0.999 makes the first input visible at the end."""
    B, S, D, St = 1, 128, 8, 4
    a = np.full((B, S, D, St), 0.999, np.float32)
    b = np.zeros((B, S, D, St), np.float32)
    b[:, 0] = 1.0
    c = np.ones((B, S, St), np.float32)
    y, h = ssm_scan(*(torch.from_numpy(x) for x in (a, b, c)))
    np.testing.assert_allclose(float(y[0, -1, 0]), St * 0.999 ** (S - 1), rtol=1e-4)
    ky, kh = j_ssm_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), block_d=8,
                        block_s=16, interpret=True)
    _close(y, ky)
    _close(h, kh)


def test_bf16_c_is_upcast():
    """c arrives in bf16 from the model's bf16 ``x_proj``: both upcast it."""
    a, b, c, h0 = _inputs(2, 11, 6, 16, seed=4)
    c16 = torch.from_numpy(c).bfloat16()
    y, h = ssm_scan(torch.from_numpy(a), torch.from_numpy(b), c16, torch.from_numpy(h0))
    ry, rh = ssm_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c).astype(jnp.bfloat16),
                          jnp.asarray(h0))
    _close(y, ry)
    _close(h, rh)


def test_one_step_from_the_cache_is_the_decode_update():
    """S = 1 from a cached state is the reference's decode update
    ``h = a·h + b``, ``y = einsum("bds,bs->bd", h, c)``, bit for bit."""
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(4, 1, 12, 16, seed=5))
    y, h = ssm_scan(a, b, c, h0)
    want_h = a[:, 0] * h0 + b[:, 0]
    assert torch.equal(h, want_h)
    assert torch.equal(y[:, 0], torch.einsum("bds,bs->bd", want_h, c[:, 0]))


def test_custom_op_on_cpu_is_the_plain_version():
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(2, 7, 5, 16, seed=9))
    before = ssm_scan_cuda.launches
    y, h = ssm_scan(a, b, c, h0)
    assert ssm_scan_cuda.launches == before              # the CPU never counts a launch
    py, ph = ssm_scan_plain(a, b, c, h0)
    assert torch.equal(y, py) and torch.equal(h, ph)
    # strided views go through .contiguous() first
    y2, _ = ssm_scan(a.transpose(2, 3).contiguous().transpose(2, 3), b, c, h0)
    assert torch.equal(y2, py)
    with pytest.raises(ValueError, match="needs CUDA"):
        ssm_scan_cuda(a, b, c, h0)
    with pytest.raises(ValueError, match=r"\[B, S, St\]"):
        ssm_scan(a, b, c[:, :, :3], h0)


def test_fake_op_gives_the_output_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty((2, 9, 6, 16))
        y, h = torch.ops.repro_torch.ssm_scan(a, a, torch.empty((2, 9, 16),
                                                                dtype=torch.bfloat16), None)
    assert (tuple(y.shape), y.dtype) == ((2, 9, 6), torch.float32)
    assert (tuple(h.shape), h.dtype) == ((2, 6, 16), torch.float32)
