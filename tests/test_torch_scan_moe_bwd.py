"""The backward ops of B5 (grouped expert matmul), B6 (selective scan) and
B7 (RG-LRU recurrence) on the CPU: each plain backward against ``jax.vjp``
of the reference's ``ref.py`` function on the same numpy inputs and
cotangents (a nonzero ``h_last`` cotangent, with and without ``h0``, S = 1,
bf16 operands and a bf16 ``c``), autograd through each custom op against
its plain backward, and each backward op as one node of a ``make_fx``
capture.  The CUDA kernels themselves run in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.

Tolerances: 2e-5 in f32 (the two frameworks sum in other orders) and 3e-2
with bf16 operands (the two round at other places), as
``tests/test_kernels.py`` holds the forwards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd_cuda, moe_gmm_bwd_plain
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd_cuda, rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_bwd_cuda, ssm_scan_bwd_plain,
                                          ssm_scan_plain)

TOL = {"f32": 2e-5, "bf16": 3e-2}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a: np.ndarray, dt=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dt)


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol, err_msg=what)


# -- B7: the RG-LRU recurrence ------------------------------------------------

def _rglru_case(B, S, R, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R))
    b = rng.standard_normal((B, S, R))
    h0 = rng.standard_normal((B, R))
    dhs = rng.standard_normal((B, S, R))
    dh_last = rng.standard_normal((B, R))
    return a, b, h0, dhs, dh_last


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,R", [(2, 9, 16), (3, 1, 5), (1, 40, 3)])
def test_rglru_plain_backward_matches_vjp_of_ref(B, S, R, with_h0, dt):
    a, b, h0, dhs, dh_last = _rglru_case(B, S, R, S + R)
    jdt, tdt = DT[dt]
    if not with_h0:
        h0 = np.zeros_like(h0)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    _, vjp = jax.vjp(rglru_scan_ref, ja, jb, jnp.asarray(h0, jnp.float32))
    want_da, want_db, want_dh0 = vjp((jnp.asarray(dhs, jnp.float32),
                                      jnp.asarray(dh_last, jnp.float32)))
    ta, tb = _t(a, tdt), _t(b, tdt)
    th0 = _t(h0) if with_h0 else None
    hs, _ = rglru_scan_plain(ta, tb, th0)
    da, db, dh0 = rglru_scan_bwd_plain(ta, hs, th0, _t(dhs), _t(dh_last))
    tol = TOL[dt]
    _close(da, want_da, tol, "da")
    _close(db, want_db, tol, "db")
    _close(dh0, want_dh0, tol, "dh0")
    assert da.dtype == tdt and dh0.dtype == torch.float32


# -- B6: the selective scan ---------------------------------------------------

def _ssm_case(B, S, D, St, seed):
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.001, 0.1, (B, S, D, 1)) * np.arange(1, St + 1))
    b = rng.standard_normal((B, S, D, St)) * 0.1
    c = rng.standard_normal((B, S, St))
    h0 = rng.standard_normal((B, D, St))
    dy = rng.standard_normal((B, S, D))
    dh_last = rng.standard_normal((B, D, St))
    return a, b, c, h0, dy, dh_last


@pytest.mark.parametrize("c_dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,D,St", [(2, 9, 6, 4), (3, 1, 5, 16), (1, 33, 3, 5)])
def test_ssm_plain_backward_matches_vjp_of_ref(B, S, D, St, with_h0, c_dt):
    """a and b stay f32 (the model's discretisation is f32); c is f32 or
    the bf16 a bf16 model's x_proj gives it, and dc comes back in c's
    dtype."""
    a, b, c, h0, dy, dh_last = _ssm_case(B, S, D, St, S + D)
    if not with_h0:
        h0 = np.zeros_like(h0)
    cj, ct = DT[c_dt]
    _, vjp = jax.vjp(ssm_scan_ref, jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                     jnp.asarray(c, cj), jnp.asarray(h0, jnp.float32))
    want = vjp((jnp.asarray(dy, jnp.float32), jnp.asarray(dh_last, jnp.float32)))
    th0 = _t(h0) if with_h0 else None
    got = ssm_scan_bwd_plain(_t(a), _t(b), _t(c, ct), th0, _t(dy), _t(dh_last))
    for name, g, w in zip(("da", "db", "dc", "dh0"), got, want):
        _close(g, w, TOL["bf16" if name == "dc" else "f32"] if c_dt == "bf16" else TOL["f32"],
               name)
    assert got[2].dtype == ct and got[0].dtype == torch.float32


def test_ssm_plain_backward_in_bf16_operands():
    """bf16 a and b (upcast by the reference too): the gradients come back
    in their dtype, within the bf16 tolerance."""
    a, b, c, h0, dy, dh_last = _ssm_case(2, 7, 4, 4, 3)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(ssm_scan_ref, jnp.asarray(a, bf), jnp.asarray(b, bf), jnp.asarray(c, bf),
                     jnp.asarray(h0, jnp.float32))
    want = vjp((jnp.asarray(dy, jnp.float32), jnp.asarray(dh_last, jnp.float32)))
    got = ssm_scan_bwd_plain(_t(a, torch.bfloat16), _t(b, torch.bfloat16),
                             _t(c, torch.bfloat16), _t(h0), _t(dy), _t(dh_last))
    for name, g, w in zip(("da", "db", "dc", "dh0"), got, want):
        _close(g, w, TOL["bf16"], name)
    assert [t.dtype for t in got[:3]] == [torch.bfloat16] * 3


# -- B5: the grouped expert matmul --------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", [(4, 24, 64, 32), (3, 37, 20, 9), (1, 1, 8, 16)])
def test_moe_gmm_plain_backward_matches_vjp_of_ref(E, C, D, F, dt):
    rng = np.random.default_rng(E + C + D + F)
    x = rng.standard_normal((E, C, D))
    w = rng.standard_normal((E, D, F)) * D ** -0.5
    dy = rng.standard_normal((E, C, F)) * 0.25 * C ** -0.5
    jdt, tdt = DT[dt]
    _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(dy, jdt))
    dx, dw = moe_gmm_bwd_plain(_t(x, tdt), _t(w, tdt), _t(dy, tdt))
    assert dx.dtype == tdt and dw.dtype == tdt
    _close(dx, want_dx, TOL[dt], "dx")
    _close(dw, want_dw, TOL[dt], "dw")


# -- autograd through the custom ops ------------------------------------------

def _grads(fn, args, cots):
    args = [None if t is None else t.clone().requires_grad_(True) for t in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    live = [t for t in args if t is not None]
    return torch.autograd.grad(outs, live, cots)


def test_autograd_through_rglru_scan_is_its_plain_backward():
    a, b, h0, dhs, dh_last = _rglru_case(2, 11, 7, 0)
    for h in (_t(h0), None):
        args = [_t(a), _t(b), h]
        hs, _ = rglru_scan_plain(*args)
        want = rglru_scan_bwd_plain(args[0], hs, h, _t(dhs), _t(dh_last))
        got = _grads(rglru_scan, args, (_t(dhs), _t(dh_last)))
        assert len(got) == (3 if h is not None else 2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_autograd_through_ssm_scan_is_its_plain_backward():
    a, b, c, h0, dy, dh_last = _ssm_case(2, 6, 5, 4, 1)
    for h in (_t(h0), None):
        args = [_t(a), _t(b), _t(c, torch.bfloat16), h]
        want = ssm_scan_bwd_plain(*args, _t(dy), _t(dh_last))
        got = _grads(ssm_scan, args, (_t(dy), _t(dh_last)))
        assert len(got) == (4 if h is not None else 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[2].dtype == torch.bfloat16


def test_autograd_through_moe_gmm_is_its_plain_backward():
    rng = np.random.default_rng(2)
    for tdt in (torch.float32, torch.bfloat16):
        x, w = _t(rng.standard_normal((3, 10, 16)), tdt), _t(rng.standard_normal((3, 16, 8)), tdt)
        dy = _t(rng.standard_normal((3, 10, 8)), tdt)
        want = moe_gmm_bwd_plain(x, w, dy)
        got = _grads(moe_gmm, [x, w], (dy,))
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_unused_h_last_gets_a_zero_cotangent():
    """A model uses only ``hs`` / ``y``: autograd hands the backward op a
    zero ``h_last`` cotangent, the same gradient as passing one."""
    a, b, h0, dhs, _ = _rglru_case(1, 5, 4, 7)
    ta = _t(a).requires_grad_(True)
    hs, _ = rglru_scan(ta, _t(b))
    (g,) = torch.autograd.grad(hs, ta, _t(dhs))
    want = rglru_scan_bwd_plain(_t(a), hs.detach(), None, _t(dhs), torch.zeros((1, 4)))[0]
    assert torch.equal(g, want)


# -- capture -------------------------------------------------------------------

def _captured_ops(fn, *args) -> set[str]:
    gm = make_fx(fn)(*args)
    return {getattr(getattr(n.target, "overloadpacket", None), "__name__", "")
            for n in gm.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("which", ["moe_gmm", "ssm_scan", "rglru_scan"])
def test_each_backward_op_traces_under_make_fx(which):
    """The gradient of each op captured the way ``compile_lm_loss(grad=True)``
    captures it (``torch.autograd.grad`` inside ``make_fx``): the forward
    and the backward op each one node, their fake implementations giving
    the shapes."""
    rng = np.random.default_rng(3)
    if which == "moe_gmm":
        args = (_t(rng.standard_normal((2, 6, 8))), _t(rng.standard_normal((2, 8, 4))))
        fwd = moe_gmm
    elif which == "ssm_scan":
        a, b, c, _, _, _ = _ssm_case(2, 5, 3, 4, 4)
        args = (_t(a), _t(b), _t(c))
        fwd = lambda a, b, c: ssm_scan(a, b, c)[0]  # noqa: E731
    else:
        a, b, _, _, _ = _rglru_case(2, 5, 3, 5)
        args = (_t(a), _t(b))
        fwd = lambda a, b: rglru_scan(a, b)[0]  # noqa: E731

    def loss_and_grads(*xs):
        with torch.enable_grad():
            live = [x.detach().requires_grad_(True) for x in xs]
            out = (fwd(*live) ** 2).sum()
            return (out, *torch.autograd.grad(out, live))

    names = _captured_ops(loss_and_grads, *args)
    assert {which, which + "_bwd"} <= names
    eager = loss_and_grads(*args)
    traced = make_fx(loss_and_grads)(*args)(*args)
    assert all(torch.equal(a, b) for a, b in zip(eager, traced))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no CPU fallback."""
    x, w = torch.zeros((1, 2, 8)), torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="needs CUDA"):
        moe_gmm_bwd_cuda(x, w, torch.zeros((1, 2, 8)))
    a = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError, match="needs CUDA"):
        ssm_scan_bwd_cuda(a, a, torch.zeros((1, 2, 4)), None, torch.zeros((1, 2, 3)),
                          torch.zeros((1, 3, 4)))
    a = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_scan_bwd_cuda(a, a, None, a, torch.zeros((1, 3)))
