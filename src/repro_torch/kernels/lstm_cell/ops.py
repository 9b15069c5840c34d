"""Fused LSTM cell update (the paper's elementwise hot spot, Fig 2b / §5.2):
the dispatching op, its CUDA wrapper and its plain PyTorch version.

``lstm_cell_fused(gx, gh, b, c)`` takes the reference's layout: the two GEMM
outputs ``gx, gh [N, 4H]`` (gate order i|f|g|o), the bias ``b [4H]`` and the
cell state ``c [N, H]``, and returns ``(h [N, H] in gx's dtype, c' [N, H] in
c's dtype)``.  It is registered as the custom op ``repro_torch::lstm_cell``
(with a fake implementation), so capture sees one graph node per cell.
Inside the op the device decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/lstm_cell.cu``, replacing the TPU kernel
  ``repro/kernels/lstm_cell/kernel.py::lstm_cell_kernel_call``) or raises —
  there is no fallback.  It takes any N and H (the TPU kernel needs block
  sizes that tile both); :func:`cell_tiles` picks its grid;
* a CPU tensor takes :func:`lstm_cell_plain`, op for op the JAX package's
  ``lstm_cell_ref``, so the CPU tests hold the port to the reference.

Its gradient is registered with ``torch.library.register_autograd``: the
op ``repro_torch::lstm_cell_bwd`` recomputes the gates and ``c'`` from the
forward's inputs and returns ``dgates [N, 4H]`` (the gradient of both ``gx``
and ``gh``, in gx's dtype) and the gradient of ``c`` (in c's dtype); the
bias's is ``dgates`` summed over the rows in f32.  On a CUDA tensor it is
the hand-written kernel ``lstm_cell_bwd`` beside the forward in
``csrc/lstm_cell.cu`` (or a raise), on a CPU tensor
:func:`lstm_cell_bwd_plain`.  The JAX package has no backward kernel (XLA
differentiates ``core/wavefront.py::lstm_cell``); the CPU tests hold the
plain backward to its gradients.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["CellTiles", "cell_tiles", "lstm_cell_bwd_cuda", "lstm_cell_bwd_plain",
           "lstm_cell_cuda", "lstm_cell_fused", "lstm_cell_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_MAX_CTAS = 132 * 32       # the kernel's grid stops there and strides


class CellTiles(NamedTuple):
    """The kernel's grid: ``cols`` consecutive columns of one row per thread
    (1, 2 or 4; one vector load each where H and the pointers allow) and
    ``threads`` per CTA."""
    cols: int
    threads: int


def cell_tiles(N: int, H: int, itemsize: int = 4, sms: int = 132) -> CellTiles:
    """One 4-byte word of each gate stream per thread (1 column of f32
    gates, 2 of bf16), so a warp's load is 128 contiguous bytes; CTAs of
    256 threads where those still give every one of the card's ``sms`` SMs
    a CTA, else of 128.  At N = 64, H = 1024, f32 that is 256 CTAs of 256
    threads, where 4 columns in CTAs of 256 gave 64 and left 68 SMs idle
    (the sweep in ``scripts/torch_scan_probe.py``: 4-column grids were the
    slowest at every CTA size)."""
    cols = max(1, 4 // itemsize)
    for threads in (256, 128):
        if ctas(N, H, CellTiles(cols, threads)) >= sms:
            return CellTiles(cols, threads)
    return CellTiles(cols, 128)


def ctas(N: int, H: int, tiles: CellTiles) -> int:
    """CTAs the kernel launches for these tiles (a grid-stride loop past
    32 an SM)."""
    return min(-(-N * -(-H // tiles.cols) // tiles.threads), _MAX_CTAS)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lstm_cell_plain(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``g = gx + gh + b`` in f32, ``c' = σ(f+1)·c + σ(i)·tanh(g)``,
    ``h = σ(o)·tanh(c')`` — op for op ``lstm_cell_ref``.  Returns
    ``(h in gx's dtype, c' in c's dtype)``."""
    gates = gx.float() + gh.float() + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c_new)
    return h.to(gx.dtype), c_new.to(c.dtype)


def lstm_cell_bwd_plain(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, dh: torch.Tensor,
                        dc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell's gradient as the backward kernel computes it: the gates
    and ``c'`` recomputed in f32 as :func:`lstm_cell_plain` does, then
    ``dgates`` (the gradient of the summed gates, i|f|g|o; in gx's dtype)
    and the gradient of ``c`` (in c's dtype) from ``dh`` and ``dc`` (the
    gradients of ``h`` and ``c'``)."""
    gates = gx.float() + gh.float() + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    si, sf, so, tg = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o), torch.tanh(g)
    cf = c.float()
    tc = torch.tanh(sf * cf + si * tg)
    dh, dcn = dh.float(), dc.float()
    dct = dcn + dh * so * (1.0 - tc * tc)
    dgates = torch.cat([dct * tg * si * (1.0 - si), dct * cf * sf * (1.0 - sf),
                        dct * si * (1.0 - tg * tg), dh * tc * so * (1.0 - so)], dim=-1)
    return dgates.to(gx.dtype), (dct * sf).to(c.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("lstm_cell")
    fn = lib.lstm_cell_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bwd = lib.lstm_cell_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib


def _check_cuda(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                *extra: tuple[str, torch.Tensor, torch.dtype]) -> tuple[int, int]:
    """The kernels' input checks; returns ``(N, H)``.  ``extra``: more
    ``[N, H]`` tensors (the backward's gradients) with their dtypes."""
    if not gx.is_cuda:
        raise ValueError(f"lstm_cell_cuda: needs CUDA tensors, gx is on {gx.device}")
    if gx.dim() != 2 or gx.shape[1] % 4 or gx.shape[1] == 0:
        raise ValueError(f"lstm_cell: gx must be [N, 4H], got {tuple(gx.shape)}")
    N, H = gx.shape[0], gx.shape[1] // 4
    if gh.shape != gx.shape or b.shape != (4 * H,) or c.shape != (N, H):
        raise ValueError(f"lstm_cell: gx {tuple(gx.shape)} does not fit gh "
                         f"{tuple(gh.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    for name, t in (("gx", gx), ("gh", gh), ("b", b), ("c", c)) + tuple(e[:2] for e in extra):
        if t.device != gx.device:
            raise ValueError(f"lstm_cell: {name} on {t.device}, gx on {gx.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} is not contiguous")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"lstm_cell: {name} has unsupported dtype {t.dtype} "
                            "(float32 or bfloat16)")
    if gh.dtype != gx.dtype or b.dtype != gx.dtype:
        raise TypeError(f"lstm_cell: gh is {gh.dtype} and b {b.dtype}, gx is {gx.dtype}")
    for name, t, dtype in extra:
        if t.shape != (N, H) or t.dtype != dtype:
            raise ValueError(f"lstm_cell: {name} must be {dtype} {(N, H)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return N, H


def _tiles(gx: torch.Tensor, N: int, H: int) -> CellTiles:
    return cell_tiles(N, H, gx.element_size(),
                      _sm_count(gx.device.index if gx.device.index is not None else 0))


def lstm_cell_cuda(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (the executor's).

    ``gx, gh [N, 4H]`` and ``b [4H]`` in one dtype, ``c [N, H]``; the
    gates and the state each in f32 or bf16, all contiguous on one card.
    Raises on anything the kernel does not take and on a refused launch.
    Counts one in ``lstm_cell_cuda.launches`` per launch."""
    N, H = _check_cuda(gx, gh, b, c)
    h = torch.empty((N, H), dtype=gx.dtype, device=gx.device)
    c_new = torch.empty((N, H), dtype=c.dtype, device=gx.device)
    if N == 0:
        return h, c_new
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    err = _lib().lstm_cell_fwd(
        gx.data_ptr(), gh.data_ptr(), b.data_ptr(), c.data_ptr(), h.data_ptr(),
        c_new.data_ptr(), _DTYPE_CODES[gx.dtype], _DTYPE_CODES[c.dtype], N, H,
        *_tiles(gx, N, H), stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {err}")
    with _count_lock:
        lstm_cell_cuda.launches += 1
    return h, c_new


lstm_cell_cuda.launches = 0


def lstm_cell_bwd_cuda(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dh: torch.Tensor, dc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (``lstm_cell_bwd`` in ``csrc/lstm_cell.cu``)
    on the current stream: the forward's inputs, ``dh [N, H]`` in the gates'
    dtype and ``dc [N, H]`` in the state's.  Returns ``(dgates [N, 4H],
    dc_prev [N, H])``.  The same checks as the forward; raises on a refused
    launch.  Counts one in ``lstm_cell_bwd_cuda.launches`` per launch."""
    N, H = _check_cuda(gx, gh, b, c, ("dh", dh, gx.dtype), ("dc", dc, c.dtype))
    dgates = torch.empty_like(gx)
    dc_prev = torch.empty_like(c)
    if N == 0:
        return dgates, dc_prev
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    err = _lib().lstm_cell_bwd(
        gx.data_ptr(), gh.data_ptr(), b.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),
        dgates.data_ptr(), dc_prev.data_ptr(), _DTYPE_CODES[gx.dtype], _DTYPE_CODES[c.dtype],
        N, H, _tiles(gx, N, H).threads, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        lstm_cell_bwd_cuda.launches += 1
    return dgates, dc_prev


lstm_cell_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::lstm_cell", mutates_args=())
def _lstm_cell_op(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if gx.is_cuda:
        return lstm_cell_cuda(gx, gh, b, c)
    if gx.device.type == "cpu":
        return lstm_cell_plain(gx, gh, b, c)
    raise NotImplementedError(f"lstm_cell: no path for device {gx.device}")


@_lstm_cell_op.register_fake
def _(gx, gh, b, c):
    N, H = gx.shape[0], gx.shape[1] // 4
    return gx.new_empty((N, H)), c.new_empty((N, H))


@torch.library.custom_op("repro_torch::lstm_cell_bwd", mutates_args=())
def _lstm_cell_bwd_op(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      dh: torch.Tensor, dc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if gx.is_cuda:
        return lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc)
    if gx.device.type == "cpu":
        return lstm_cell_bwd_plain(gx, gh, b, c, dh, dc)
    raise NotImplementedError(f"lstm_cell_bwd: no path for device {gx.device}")


@_lstm_cell_bwd_op.register_fake
def _(gx, gh, b, c, dh, dc):
    return torch.empty_like(gx), torch.empty_like(c)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dh, dc):
    gx, gh, b, c = ctx.saved_tensors
    dgates, dc_prev = torch.ops.repro_torch.lstm_cell_bwd(
        gx, gh, b, c, dh.contiguous().to(gx.dtype), dc.contiguous().to(c.dtype))
    db = dgates.float().sum(0).to(b.dtype)
    return dgates, dgates, db, dc_prev


_lstm_cell_op.register_autograd(_backward, setup_context=_setup_context)


def lstm_cell_fused(gx: torch.Tensor, gh: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused cell update over the reference's ``[N, 4H]`` gate layout
    (``repro/kernels/lstm_cell/ops.py::lstm_cell_fused``; the kernel tiles
    on its own, so there are no block sizes).  Returns ``(h, c')``."""
    return torch.ops.repro_torch.lstm_cell(gx.contiguous(), gh.contiguous(), b.contiguous(),
                                           c.contiguous())
