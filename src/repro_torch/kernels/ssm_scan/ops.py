"""Mamba selective scan (falcon-mamba's recurrence): the dispatching op, its
CUDA wrapper and its plain PyTorch version.

``ssm_scan(a, b, c, h0=None)`` takes the reference's layout: the
discretised decay and input ``a, b [B, S, D, St]`` (f32), the output
projection ``c [B, S, St]`` (f32 or bf16, upcast) and an optional
starting state ``h0 [B, D, St]`` (f32; zero when absent, as the TPU kernel
starts).  It returns ``(y [B, S, D] f32, h_last [B, D, St] f32)`` with
``h_t = a_t·h_{t-1} + b_t`` and ``y_t = Σ_St h_t·c_t``.  Taking ``h0`` is
what lets a decode step (``S = 1``, ``h0`` = the cached state) use the
same op as the prefill.  It is registered as the custom op
``repro_torch::ssm_scan`` (with a fake implementation), so capture sees one
graph node per scan.  Inside the op the device decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/ssm_scan.cu``, replacing the TPU kernel
  ``repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel_call``) or raises —
  there is no fallback.  It takes any B, S and D and any St up to 32 (the
  TPU kernel needs block sizes that tile D and S);
* a CPU tensor takes :func:`ssm_scan_plain`, op for op the JAX package's
  ``ssm_scan_ref``, so the CPU tests hold the port to the reference.

Training has two more ops.  ``repro_torch::ssm_scan_train`` is the same
forward kernel with one more store: it also returns ``h_ckpt [B,
ceil(S / CKPT_CHUNK), D, St]`` f32, the state at the end of every
``CKPT_CHUNK``-step chunk (the last at ``t = S-1``), and its y and h_last
are bit-identical to ``repro_torch::ssm_scan``'s.  Its gradient is
registered with ``torch.library.register_autograd``: the op
``repro_torch::ssm_scan_bwd`` walks the reverse scan ``dh_t = dy_t ⊗ c_t
+ a_{t+1}·dh_{t+1}`` from the ``h_last`` cotangent and returns ``(da, db,
dc, dh0)`` (``da_t = dh_t·h_{t-1}``, ``db_t = dh_t``, ``dc_t = Σ_D h_t·dy_t``
in c's dtype, ``dh0 = a_0·dh_0``), re-running each chunk's states from
its checkpoint.  On a CUDA tensor it is the hand-written kernel
``ssm_scan_bwd`` beside the forward in ``csrc/ssm_scan.cu`` (or a raise),
on a CPU tensor :func:`ssm_scan_bwd_plain`, ``jax.vjp`` of ``ssm_scan_ref``
step by step.  The serving op has no gradient (as B3's): a model takes
the training op while autograd records (``models/mamba.py``).  The JAX
package has no backward kernel (XLA differentiates its jnp scan).
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["CKPT_CHUNK", "ssm_scan", "ssm_scan_bwd_cuda", "ssm_scan_bwd_plain", "ssm_scan_cuda",
           "ssm_scan_plain", "ssm_scan_train", "ssm_scan_train_cuda", "ssm_scan_train_plain"]

# steps between two checkpoints of the training forward (kCkptChunk in
# csrc/ssm_scan.cu): the backward kernel stages a chunk's a and b (64 KB
# at St = 16 for its 16 channels) twice over in shared memory, so a CTA
# fits on an SM; the checkpoints cost a 32nd of a's bytes
CKPT_CHUNK = 32

_C_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STATE = 32
_count_lock = threading.Lock()


def _chain(a32: torch.Tensor, b32: torch.Tensor, h: torch.Tensor, t0: int, t1: int,
           visit) -> torch.Tensor:
    """Steps ``t0 .. t1-1`` of ``h = a_t·h + b_t`` from ``h`` in f32 (the
    product and the sum rounded apart), calling ``visit(t, h_{t-1}, h_t)``
    after each step; returns the last state."""
    for t in range(t0, t1):
        prev = h
        h = a32[:, t] * h + b32[:, t]
        visit(t, prev, h)
    return h


def _zero_state(a: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    B, _, D, St = a.shape
    return (torch.zeros((B, D, St), dtype=torch.float32, device=a.device) if h0 is None
            else h0.float())


def _n_chunks(S: int) -> int:
    return -(-S // CKPT_CHUNK)


def ssm_scan_train_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, ...]:
    """:func:`ssm_scan_plain` that also keeps the state at the end of every
    ``CKPT_CHUNK``-step chunk (the last at ``t = S-1``).  Returns ``(y [B,
    S, D], h_last [B, D, St], h_ckpt [B, ceil(S / CKPT_CHUNK), D, St])``,
    all f32; y and h_last are :func:`ssm_scan_plain`'s."""
    a32, b32, c32 = a.float(), b.float(), c.float()
    B, S, D, St = a.shape
    ys, ckpt = [], []

    def visit(t, _prev, h):
        ys.append(torch.einsum("bds,bs->bd", h, c32[:, t]))
        if (t + 1) % CKPT_CHUNK == 0 or t == S - 1:
            ckpt.append(h)

    h = _chain(a32, b32, _zero_state(a, h0), 0, S, visit)
    y = torch.stack(ys, dim=1) if ys else a32.new_zeros((B, 0, D))
    h_ckpt = torch.stack(ckpt, dim=1) if ckpt else a32.new_zeros((B, 0, D, St))
    return y, h, h_ckpt


def ssm_scan_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A step-by-step loop over S in f32 — ``ssm_scan_ref`` (``h0`` absent:
    zeros).  Returns ``(y [B, S, D], h_last [B, D, St])``."""
    return ssm_scan_train_plain(a, b, c, h0)[:2]


def ssm_scan_bwd_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       h0: Optional[torch.Tensor], dy: torch.Tensor, dh_last: torch.Tensor,
                       h_ckpt: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, ...]:
    """The reverse scan in f32, step by step — ``jax.vjp`` of
    ``ssm_scan_ref``: the states recomputed by the forward loop, then from
    ``g = dh_last``, for t = S-1 .. 0, ``g = g + dy_t ⊗ c_t``, ``dc_t =
    Σ_d h_t·dy_t``, ``da_t = g·h_{t-1}``, ``db_t = g``, ``g = g·a_t``.  With
    the training forward's checkpoints ``h_ckpt``, chunk by chunk from the
    last, each chunk's states re-run from the checkpoint before it, as the
    kernel does: the same numbers, since a checkpoint is the exact state.
    Returns ``(da, db [B, S, D, St] in a's dtype, dc [B, S, St] in c's
    dtype, dh0 [B, D, St] f32)``."""
    a32, b32, c32, dy = a.float(), b.float(), c.float(), dy.float()
    B, S, D, St = a.shape
    chunk = max(S, 1) if h_ckpt is None else CKPT_CHUNK
    g = dh_last.float()
    da = torch.empty((B, S, D, St), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    dc = torch.empty((B, S, St), dtype=torch.float32, device=a.device)
    for j in reversed(range(-(-S // chunk))):
        t0, t1 = j * chunk, min(S, (j + 1) * chunk)
        start = _zero_state(a, h0) if j == 0 else h_ckpt[:, j - 1].float()
        prev = []                               # h_{t-1} of every step of the chunk
        h = _chain(a32, b32, start, t0, t1, lambda t, p, _h: prev.append(p))
        for t in reversed(range(t0, t1)):
            g = g + dy[:, t, :, None] * c32[:, t, None, :]
            dc[:, t] = torch.einsum("bds,bd->bs", h, dy[:, t])
            da[:, t] = g * prev[t - t0]
            db[:, t] = g
            g = g * a32[:, t]
            h = prev[t - t0]
    return da.to(a.dtype), db.to(a.dtype), dc.to(c.dtype), g


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    train = lib.ssm_scan_train_fwd
    train.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3
                      + [ctypes.c_int, ctypes.c_void_p])
    train.restype = ctypes.c_int
    bwd = lib.ssm_scan_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    part = lib.ssm_scan_bwd_part_floats
    part.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    part.restype = ctypes.c_longlong
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"ssm_scan: a and b must be [B, S, D, St], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    B, S, D, St = a.shape
    if c.shape != (B, S, St):
        raise ValueError(f"ssm_scan: c must be [B, S, St] = {(B, S, St)}, got {tuple(c.shape)}")
    if h0 is not None and h0.shape != (B, D, St):
        raise ValueError(f"ssm_scan: h0 must be [B, D, St] = {(B, D, St)}, "
                         f"got {tuple(h0.shape)}")


def _check_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                h0: Optional[torch.Tensor], *extra: tuple[str, torch.Tensor]) -> None:
    """The kernels' checks: shapes, ``St``, one card, contiguous, f32
    (``c`` also bf16); ``extra`` are more f32 operands (the backward's)."""
    if not a.is_cuda:
        raise ValueError(f"ssm_scan_cuda: needs CUDA tensors, a is on {a.device}")
    _check(a, b, c, h0)
    St = a.shape[3]
    if not 1 <= St <= _MAX_STATE:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= St <= {_MAX_STATE}, got St={St}")
    named = [("a", a), ("b", b), ("c", c)] + ([] if h0 is None else [("h0", h0)]) + list(extra)
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")
        if t.dtype != torch.float32 and not (name == "c" and t.dtype in _C_DTYPE_CODES):
            raise TypeError(f"ssm_scan: {name} has unsupported dtype {t.dtype} "
                            "(float32; c also bfloat16)")


def _forward_cuda(a, b, c, h0, h_ckpt) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel (the training form when ``h_ckpt``
    is given), after :func:`_check_cuda`.  Returns ``(y, h_last)``."""
    B, S, D, St = a.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    if B * S * D == 0:
        h_last = (torch.zeros((B, D, St), dtype=torch.float32, device=a.device) if h0 is None
                  else h0.clone())
        return y, h_last
    h_last = torch.empty((B, D, St), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr())
    if h_ckpt is None:
        err = _lib().ssm_scan_fwd(*args, _C_DTYPE_CODES[c.dtype], B, S, D, St, stream)
    else:
        err = _lib().ssm_scan_train_fwd(*args, h_ckpt.data_ptr(), CKPT_CHUNK,
                                        _C_DTYPE_CODES[c.dtype], B, S, D, St, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    return y, h_last


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (the executor's).

    ``a, b [B, S, D, St]`` and ``h0 [B, D, St]`` in f32, ``c [B, S, St]``
    in f32 or bf16, all contiguous on one card, ``1 <= St <= 32``.  Raises
    on anything the kernel does not take and on a refused launch.  Counts
    one in ``ssm_scan_cuda.launches`` per launch."""
    _check_cuda(a, b, c, h0)
    y, h_last = _forward_cuda(a, b, c, h0, None)
    if y.numel():
        with _count_lock:
            ssm_scan_cuda.launches += 1
    return y, h_last


ssm_scan_cuda.launches = 0


def ssm_scan_train_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, ...]:
    """The training forward: :func:`ssm_scan_cuda`'s kernel asked for the
    state at the end of every ``CKPT_CHUNK`` steps as well.  Returns ``(y,
    h_last, h_ckpt [B, ceil(S / CKPT_CHUNK), D, St] f32)``.  Counts in
    ``ssm_scan_train_cuda.launches``, not in the serving count."""
    _check_cuda(a, b, c, h0)
    B, S, D, St = a.shape
    h_ckpt = torch.empty((B, _n_chunks(S), D, St), dtype=torch.float32, device=a.device)
    y, h_last = _forward_cuda(a, b, c, h0, h_ckpt)
    if y.numel():
        with _count_lock:
            ssm_scan_train_cuda.launches += 1
    return y, h_last, h_ckpt


ssm_scan_train_cuda.launches = 0


def ssm_scan_bwd_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor, dh_last: torch.Tensor,
                      h_ckpt: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernels (``ssm_scan_bwd`` in ``csrc/ssm_scan.cu``:
    the reverse scan from the training forward's checkpoints ``h_ckpt``
    and the fixed-order sum of ``dc``'s per-CTA partials) on the current
    stream: the forward's inputs, ``dy [B, S, D]``, ``dh_last [B, D, St]``
    and ``h_ckpt`` in f32.  Returns ``(da, db, dc, dh0)``.  The forward's
    checks; raises on a refused launch.  Counts one in
    ``ssm_scan_bwd_cuda.launches`` per call."""
    _check_cuda(a, b, c, h0, ("dy", dy), ("dh_last", dh_last), ("h_ckpt", h_ckpt))
    B, S, D, St = a.shape
    if dy.shape != (B, S, D) or dh_last.shape != (B, D, St):
        raise ValueError(f"ssm_scan_bwd: dy must be {(B, S, D)} and dh_last {(B, D, St)}, got "
                         f"{tuple(dy.shape)} and {tuple(dh_last.shape)}")
    if h_ckpt.shape != (B, _n_chunks(S), D, St):
        raise ValueError(f"ssm_scan_bwd: h_ckpt must be {(B, _n_chunks(S), D, St)}, got "
                         f"{tuple(h_ckpt.shape)}")
    da = torch.empty((B, S, D, St), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    dc = torch.empty((B, S, St), dtype=c.dtype, device=a.device)
    if B * S * D == 0:
        return da, db, dc.zero_(), dh_last.clone()
    dh0 = torch.empty((B, D, St), dtype=torch.float32, device=a.device)
    lib = _lib()
    part = torch.empty((lib.ssm_scan_bwd_part_floats(B, S, D, St),), dtype=torch.float32,
                       device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.ssm_scan_bwd(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
        h_ckpt.data_ptr(), dy.data_ptr(), dh_last.data_ptr(), da.data_ptr(), db.data_ptr(),
        dc.data_ptr(), dh0.data_ptr(), part.data_ptr(), CKPT_CHUNK, _C_DTYPE_CODES[c.dtype],
        B, S, D, St, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        ssm_scan_bwd_cuda.launches += 1
    return da, db, dc, dh0


ssm_scan_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_scan_op(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 h0: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    if a.is_cuda:
        return ssm_scan_cuda(a, b, c, h0)
    if a.device.type == "cpu":
        _check(a, b, c, h0)
        return ssm_scan_plain(a, b, c, h0)
    raise NotImplementedError(f"ssm_scan: no path for device {a.device}")


@_ssm_scan_op.register_fake
def _(a, b, c, h0):
    B, S, D, St = a.shape
    f32 = torch.float32
    return a.new_empty((B, S, D), dtype=f32), a.new_empty((B, D, St), dtype=f32)


@torch.library.custom_op("repro_torch::ssm_scan_train", mutates_args=())
def _ssm_scan_train_op(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       h0: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    if a.is_cuda:
        return ssm_scan_train_cuda(a, b, c, h0)
    if a.device.type == "cpu":
        _check(a, b, c, h0)
        return ssm_scan_train_plain(a, b, c, h0)
    raise NotImplementedError(f"ssm_scan_train: no path for device {a.device}")


@_ssm_scan_train_op.register_fake
def _(a, b, c, h0):
    B, S, D, St = a.shape
    f32 = torch.float32
    return (a.new_empty((B, S, D), dtype=f32), a.new_empty((B, D, St), dtype=f32),
            a.new_empty((B, _n_chunks(S), D, St), dtype=f32))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def _ssm_scan_bwd_op(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     h0: Optional[torch.Tensor], dy: torch.Tensor, dh_last: torch.Tensor,
                     h_ckpt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    if a.is_cuda:
        return ssm_scan_bwd_cuda(a, b, c, h0, dy, dh_last, h_ckpt)
    if a.device.type == "cpu":
        _check(a, b, c, h0)
        return ssm_scan_bwd_plain(a, b, c, h0, dy, dh_last, h_ckpt)
    raise NotImplementedError(f"ssm_scan_bwd: no path for device {a.device}")


@_ssm_scan_bwd_op.register_fake
def _(a, b, c, h0, dy, dh_last, h_ckpt):
    B, S, D, St = a.shape
    return (a.new_empty(a.shape), a.new_empty(a.shape), c.new_empty(c.shape),
            a.new_empty((B, D, St), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    ctx.b_dtype = inputs[1].dtype
    ctx.has_h0 = inputs[3] is not None
    ctx.save_for_backward(*inputs, output[2])
    ctx.mark_non_differentiable(output[2])


def _backward(ctx, dy, dh_last, _dckpt):
    a, b, c, h0, h_ckpt = ctx.saved_tensors
    da, db, dc, dh0 = torch.ops.repro_torch.ssm_scan_bwd(
        a, b, c, h0, dy.contiguous().float(), dh_last.contiguous().float(), h_ckpt)
    return da, db.to(ctx.b_dtype), dc, (dh0.to(h0.dtype) if ctx.has_h0 else None)


_ssm_scan_train_op.register_autograd(_backward, setup_context=_setup_context)


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over the reference's layout
    (``repro/kernels/ssm_scan/ops.py::ssm_scan``, plus an optional ``h0``;
    the kernel tiles on its own, so there are no block sizes).  Returns
    ``(y, h_last)``, both f32.  Not differentiable: see
    :func:`ssm_scan_train`."""
    return torch.ops.repro_torch.ssm_scan(a.contiguous(), b.contiguous(), c.contiguous(),
                                          None if h0 is None else h0.contiguous())


def ssm_scan_train(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` through the training op, which keeps its chunk
    checkpoints for the backward kernel (``repro_torch::ssm_scan_bwd``)
    that autograd runs.  Returns ``(y, h_last)``; the checkpoints stay an
    internal residual of the op."""
    return torch.ops.repro_torch.ssm_scan_train(a.contiguous(), b.contiguous(), c.contiguous(),
                                                None if h0 is None else h0.contiguous())[:2]
