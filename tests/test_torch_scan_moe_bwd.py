"""The backward ops of B5 (grouped expert matmul), B6 (selective scan) and
B7 (RG-LRU recurrence) on the CPU: each plain backward against ``jax.vjp``
of the reference's ``ref.py`` function on the same numpy inputs and
cotangents (a nonzero ``h_last`` cotangent, with and without ``h0``, S = 1,
bf16 operands and a bf16 ``c``), B6's backward also from the training
forward's chunk checkpoints (``ssm_scan_train_plain``, whose checkpoints
are held to the reference's chain on prefixes), autograd through each
custom op against its plain backward, each backward op as one node of a
``make_fx`` capture, and the order of B5-bwd's persistent tile list.  The
CUDA kernels themselves run in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

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
from repro_torch.kernels.moe_gmm import (BWD_TILE, moe_gmm, moe_gmm_bwd_cuda,
                                         moe_gmm_bwd_dw_first, moe_gmm_bwd_plain,
                                         moe_gmm_bwd_tiles)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd_cuda, rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.kernels.ssm_scan import (CKPT_CHUNK, ssm_scan, ssm_scan_bwd_cuda,
                                          ssm_scan_bwd_plain, ssm_scan_plain, ssm_scan_train,
                                          ssm_scan_train_plain)

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


K = CKPT_CHUNK


@pytest.mark.parametrize("c_dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("S", [1, K - 1, K, K + 1, 333])
def test_ssm_training_forward_keeps_the_chain_state_every_chunk(S, with_h0, c_dt):
    """``ssm_scan_train_plain``: y and h_last are ``ssm_scan_plain``'s bit
    for bit and the reference's within 2e-5; ``h_ckpt[:, j]`` is the
    reference chain's state after step ``min((j + 1) K, S) - 1``
    (``ssm_scan_ref`` on that prefix)."""
    B, D, St = 2, 3, 4
    a, b, c, h0, _, _ = _ssm_case(B, S, D, St, S)
    if not with_h0:
        h0 = np.zeros_like(h0)
    cj, ct = DT[c_dt]
    th0 = _t(h0) if with_h0 else None
    args = (_t(a), _t(b), _t(c, ct), th0)
    y, h_last, h_ckpt = ssm_scan_train_plain(*args)
    py, ph = ssm_scan_plain(*args)
    assert torch.equal(y, py) and torch.equal(h_last, ph)
    jy, jh = ssm_scan_ref(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                          jnp.asarray(c, cj), jnp.asarray(h0, jnp.float32))
    _close(y, jy, TOL["f32"], "y")
    _close(h_last, jh, TOL["f32"], "h_last")
    ends = [min((j + 1) * K, S) for j in range(-(-S // K))]
    assert tuple(h_ckpt.shape) == (B, len(ends), D, St)
    assert torch.equal(h_ckpt[:, -1], h_last)
    for j, t in enumerate(ends[:-1]):
        _, want = ssm_scan_ref(jnp.asarray(a[:, :t], jnp.float32),
                               jnp.asarray(b[:, :t], jnp.float32), jnp.asarray(c[:, :t], cj),
                               jnp.asarray(h0, jnp.float32))
        _close(h_ckpt[:, j], want, TOL["f32"], f"h_ckpt[{j}]")


@pytest.mark.parametrize("c_dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,D,St", [(2, 70, 3, 4), (1, K, 2, 16), (2, K + 1, 3, 5)])
def test_ssm_backward_from_checkpoints_matches_vjp_of_ref(B, S, D, St, with_h0, c_dt):
    """The backward given the training forward's checkpoints (each chunk
    re-run from the one before it, as the kernel does): ``jax.vjp`` of
    ``ssm_scan_ref`` within the file's tolerances, and bit for bit the
    backward that re-runs the whole chain."""
    a, b, c, h0, dy, dh_last = _ssm_case(B, S, D, St, 2 * S + D)
    if not with_h0:
        h0 = np.zeros_like(h0)
    cj, ct = DT[c_dt]
    _, vjp = jax.vjp(ssm_scan_ref, jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                     jnp.asarray(c, cj), jnp.asarray(h0, jnp.float32))
    want = vjp((jnp.asarray(dy, jnp.float32), jnp.asarray(dh_last, jnp.float32)))
    args = (_t(a), _t(b), _t(c, ct), _t(h0) if with_h0 else None)
    h_ckpt = ssm_scan_train_plain(*args)[2]
    got = ssm_scan_bwd_plain(*args, _t(dy), _t(dh_last), h_ckpt)
    for name, g, w in zip(("da", "db", "dc", "dh0"), got, want):
        _close(g, w, TOL["bf16" if name == "dc" and c_dt == "bf16" else "f32"], name)
    whole = ssm_scan_bwd_plain(*args, _t(dy), _t(dh_last))
    assert all(torch.equal(g, w) for g, w in zip(got, whole))


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
    """Through the training op (``ssm_scan_train``; the serving op has no
    gradient), S long enough for three checkpoint chunks: the plain
    backward's gradients bit for bit."""
    a, b, c, h0, dy, dh_last = _ssm_case(2, 2 * K + 6, 5, 4, 1)
    for h in (_t(h0), None):
        args = [_t(a), _t(b), _t(c, torch.bfloat16), h]
        want = ssm_scan_bwd_plain(*args, _t(dy), _t(dh_last))
        got = _grads(ssm_scan_train, args, (_t(dy), _t(dh_last)))
        assert len(got) == (4 if h is not None else 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[2].dtype == torch.bfloat16
    with pytest.raises(RuntimeError):
        _grads(ssm_scan, [_t(a), _t(b), _t(c), None], (_t(dy), _t(dh_last)))


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
    (B6's training op) and the backward op each one node, their fake
    implementations giving the shapes."""
    rng = np.random.default_rng(3)
    if which == "moe_gmm":
        args = (_t(rng.standard_normal((2, 6, 8))), _t(rng.standard_normal((2, 8, 4))))
        fwd = moe_gmm
    elif which == "ssm_scan":
        a, b, c, _, _, _ = _ssm_case(2, K + 5, 3, 4, 4)
        args = (_t(a), _t(b), _t(c))
        fwd = lambda a, b, c: ssm_scan_train(a, b, c)[0]  # noqa: E731
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
    assert {"ssm_scan_train" if which == "ssm_scan" else which, which + "_bwd"} <= names
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
                          torch.zeros((1, 3, 4)), torch.zeros((1, 1, 3, 4)))
    a = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_scan_bwd_cuda(a, a, None, a, torch.zeros((1, 3)))


# -- B5-bwd's persistent tile list ----------------------------------------------

@pytest.mark.parametrize("dx,dw", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("E,C,D,F", [(32, 640, 1024, 512), (32, 640, 512, 1024), (3, 37, 200, 72),
                                     (3, 201, 136, 200), (2, 1, 8, 16)])
def test_moe_backward_tile_list_covers_each_output_tile_once(E, C, D, F, dx, dw):
    """Every ``BWD_TILE`` tile of dX ``[C, D]`` and of dW ``[D, F]`` of every
    expert exactly once (an output not asked for: none of its tiles); the
    product with the longer sum first (dW on a tie); within a product,
    expert by expert, row tiles by column tiles."""
    bm, bn, bk = BWD_TILE
    tiles = moe_gmm_bwd_tiles(E, C, D, F, dx=dx, dw=dw)
    assert len(set(tiles)) == len(tiles)
    want = set()
    for name, M, N, on in (("dx", C, D, dx), ("dw", D, F, dw)):
        if on:
            want |= {(name, e, m, n) for e in range(E) for m in range(-(-M // bm))
                     for n in range(-(-N // bn))}
    assert set(tiles) == want
    first = "dw" if -(-C // bk) >= -(-F // bk) else "dx"
    assert moe_gmm_bwd_dw_first(C, D, F) == (first == "dw")
    kinds = [t[0] for t in tiles]
    assert kinds == sorted(kinds, key=lambda k: k != first)
    for name in ("dx", "dw"):
        own = [t[1:] for t in tiles if t[0] == name]
        assert own == sorted(own)


def test_moe_backward_tile_list_puts_the_longer_sum_first_at_granite_shapes():
    """granite-moe's training products: gate / up (D x F = 1024 x 512) sum
    dW over C = 640 (10 stages) and dX over F = 512 (8), so dW leads; down
    (512 x 1024) sums dX over 1024 (16), so dX leads.  1152 and 896 tiles
    of 128 x 256 for 132 SMs."""
    up = moe_gmm_bwd_tiles(32, 640, 1024, 512)
    down = moe_gmm_bwd_tiles(32, 640, 512, 1024)
    assert (up[0][0], up[-1][0], len(up)) == ("dw", "dx", 32 * (8 * 2 + 5 * 4))
    assert (down[0][0], down[-1][0], len(down)) == ("dx", "dw", 32 * (5 * 2 + 4 * 4))
