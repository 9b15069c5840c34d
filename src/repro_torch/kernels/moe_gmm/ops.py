"""Grouped per-expert matmul (the MoE expert FFN's three products): the
dispatching op, its CUDA wrapper and its plain PyTorch version.

``moe_gmm(x, w)`` takes the reference's layout, ``x [E, C, D]`` (each
expert's capacity slots) and ``w [E, D, F]`` (each expert's weight), and
returns ``[E, C, F]`` in ``x``'s dtype, summed in f32.  It is registered as
the custom op ``repro_torch::moe_gmm`` (with a fake implementation), so
capture sees one graph node per product.  Inside the op the device decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/moe_gmm.cu``, replacing the TPU kernel
  ``repro/kernels/moe_gmm/kernel.py::moe_gmm_kernel_call``) or raises —
  there is no fallback.  :func:`moe_gmm_path` picks its tensor-core form
  (bf16, D and F multiples of 8, 16-byte aligned operands) or its SIMT
  form (f32, and anything else), which takes any E, C, D and F (the TPU
  kernel needs block sizes that tile all three);
* a CPU tensor takes :func:`moe_gmm_plain`, op for op the JAX package's
  ``moe_gmm_ref``, so the CPU tests hold the port to the reference.

Its gradient is registered with ``torch.library.register_autograd``: the
op ``repro_torch::moe_gmm_bwd`` takes ``x``, ``w`` and the cotangent ``dy
[E, C, F]`` and returns ``dx = dy·w^T`` in x's dtype and ``dw = x^T·dy`` in
w's, each summed in f32 in one fixed order.  On a CUDA tensor it is the
hand-written kernel ``moe_gmm_bwd`` beside the forward in
``csrc/moe_gmm.cu`` (or a raise): where :func:`moe_gmm_bwd_path` allows
the tensor cores, one launch of a persistent ``wgmma`` kernel fed by TMA
that walks both products' tiles in the order :func:`moe_gmm_bwd_tiles`
gives; otherwise a SIMT launch a product.  On a CPU tensor
:func:`moe_gmm_bwd_plain`, ``jax.vjp`` of ``moe_gmm_ref``.  The JAX
package has no backward kernel (XLA differentiates its einsums).
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["BWD_TILE", "moe_gmm", "moe_gmm_bwd_cuda", "moe_gmm_bwd_dw_first",
           "moe_gmm_bwd_path", "moe_gmm_bwd_plain", "moe_gmm_bwd_tiles", "moe_gmm_cuda",
           "moe_gmm_path", "moe_gmm_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf")`` of both operands in f32, cast to x's dtype
    — ``moe_gmm_ref``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gmm_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                      dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.vjp`` of ``moe_gmm_ref``: the cotangent in f32, ``dx =
    einsum("ecf,edf->ecd")`` with w and ``dw = einsum("ecd,ecf->edf")``
    with x, both operands in f32, cast to x's and w's dtypes (contiguous,
    as the kernel's and the fake implementation's are: einsum may return a
    permuted view)."""
    g = dy.float()
    dx = torch.einsum("ecf,edf->ecd", g, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), g).to(w.dtype)
    return dx.contiguous(), dw.contiguous()


# rows, columns and depth a stage of one output tile of the tensor-core
# backward kernel (gmm_bwd_wgmma: kWM, kWN, kWK in csrc/moe_gmm.cu)
BWD_TILE = (128, 256, 64)


def moe_gmm_bwd_dw_first(C: int, D: int, F: int) -> bool:
    """Whether the backward kernel's tile list puts dW's tiles before dX's:
    the product with the longer sum (more ``BWD_TILE[2]``-deep stages; dW's
    runs over C, dX's over F) goes first, dW on a tie, so the shorter
    product's tiles fill the persistent grid's last wave."""
    depth = BWD_TILE[2]
    return -(-C // depth) >= -(-F // depth)


def moe_gmm_bwd_tiles(E: int, C: int, D: int, F: int, dx: bool = True,
                      dw: bool = True) -> list[tuple[str, int, int, int]]:
    """The tensor-core backward kernel's work list, in the order its
    persistent grid takes it (CTA ``i`` of ``g`` takes entries ``i, i + g,
    ...``): ``(product, expert, row tile, column tile)`` for every
    ``BWD_TILE[0] x BWD_TILE[1]`` tile of dX ``[C, D]`` and of dW ``[D, F]``
    of every expert; within a product expert by expert, row tiles by
    column tiles; the first product by :func:`moe_gmm_bwd_dw_first`.  A
    product whose output is not asked for (``dx`` / ``dw`` False) has no
    tiles.  ``gmm_bwd_wgmma`` (``WProblem::tile``) decodes the same list
    from a tile's index."""
    bm, bn, _ = BWD_TILE

    def tiles(name: str, M: int, N: int) -> list[tuple[str, int, int, int]]:
        mt, nt = -(-M // bm), -(-N // bn)
        return [(name, e, m, n) for e in range(E) for m in range(mt) for n in range(nt)]

    x = tiles("dx", C, D) if dx else []
    w = tiles("dw", D, F) if dw else []
    return w + x if moe_gmm_bwd_dw_first(C, D, F) else x + w


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bwd = lib.moe_gmm_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 4
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x must be [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def moe_gmm_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel form a launch takes: ``"mma"`` (tensor cores; bf16, D and
    F multiples of 8, both operands 16-byte aligned, as its 16-byte async
    copies need) or ``"simt"`` (f32 FMAs: f32 operands, whose TF32 tensor
    cores would miss the 2e-5 bar, and whatever the copies cannot take)."""
    D, F = x.shape[2], w.shape[2]
    if (x.dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "mma"
    return "simt"


def moe_gmm_bwd_path(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> str:
    """The form a backward call takes: ``"mma"`` (the ``wgmma`` kernel, one
    launch for dX and dW) under the forward's condition
    (:func:`moe_gmm_path`) with the cotangent 16-byte aligned too, as TMA
    needs; else ``"simt"``."""
    return "mma" if moe_gmm_path(x, w) == "mma" and dy.data_ptr() % 16 == 0 else "simt"


def _check_cuda(x: torch.Tensor, w: torch.Tensor, *extra: tuple[str, torch.Tensor]) -> None:
    """The kernels' checks: shapes, one card, contiguous, one dtype of f32
    or bf16 (``extra``: the backward's cotangent)."""
    if not x.is_cuda:
        raise ValueError(f"moe_gmm_cuda: needs CUDA tensors, x is on {x.device}")
    _check(x, w)
    for name, t in (("x", x), ("w", w)) + extra:
        if t.device != x.device:
            raise ValueError(f"moe_gmm: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} is not contiguous")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"moe_gmm: {name} has unsupported dtype {t.dtype} "
                            "(float32 or bfloat16)")
        if t.dtype != x.dtype:
            raise TypeError(f"moe_gmm: {name} is {t.dtype}, x is {x.dtype}")


def moe_gmm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (the executor's).

    ``x [E, C, D]`` and ``w [E, D, F]``, both f32 or both bf16, contiguous,
    on one card.  Raises on anything the kernel does not take and on a
    refused launch.  Counts one in ``moe_gmm_cuda.launches`` per launch,
    and one in ``moe_gmm_cuda.launches_by_path[moe_gmm_path(x, w)]``."""
    _check_cuda(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    path = moe_gmm_path(x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             _DTYPE_CODES[x.dtype], E, C, D, F, int(path == "mma"), stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    with _count_lock:
        moe_gmm_cuda.launches += 1
        moe_gmm_cuda.launches_by_path[path] += 1
    return out


moe_gmm_cuda.launches = 0
moe_gmm_cuda.launches_by_path = {"mma": 0, "simt": 0}


def moe_gmm_bwd_cuda(x: torch.Tensor, w: torch.Tensor,
                     dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward (``moe_gmm_bwd`` in ``csrc/moe_gmm.cu``: one
    ``wgmma`` launch for dX and dW on the ``"mma"`` form, a SIMT launch a
    product otherwise) on the current stream: the forward's operands and
    the cotangent ``dy [E, C, F]`` in their dtype.  Returns ``(dx, dw)``.
    The forward's checks; raises on a refused launch (a tensor map
    libcuda will not build included).  Counts one in
    ``moe_gmm_bwd_cuda.launches`` per call, and one in
    ``moe_gmm_bwd_cuda.launches_by_path[moe_gmm_bwd_path(x, w, dy)]``."""
    _check_cuda(x, w, ("dy", dy))
    E, C, D = x.shape
    F = w.shape[2]
    if dy.shape != (E, C, F):
        raise ValueError(f"moe_gmm_bwd: dy must be {(E, C, F)}, got {tuple(dy.shape)}")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.numel() == 0 or w.numel() == 0:       # an empty sum: zero gradients
        return dx.zero_(), dw.zero_()
    path = moe_gmm_bwd_path(x, w, dy)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().moe_gmm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                             dw.data_ptr(), _DTYPE_CODES[x.dtype], E, C, D, F,
                             int(path == "mma"), int(moe_gmm_bwd_dw_first(C, D, F)), stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        moe_gmm_bwd_cuda.launches += 1
        moe_gmm_bwd_cuda.launches_by_path[path] += 1
    return dx, dw


moe_gmm_bwd_cuda.launches = 0
moe_gmm_bwd_cuda.launches_by_path = {"mma": 0, "simt": 0}


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _moe_gmm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return moe_gmm_cuda(x, w)
    if x.device.type == "cpu":
        _check(x, w)
        return moe_gmm_plain(x, w)
    raise NotImplementedError(f"moe_gmm: no path for device {x.device}")


@_moe_gmm_op.register_fake
def _(x, w):
    _check(x, w)
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op("repro_torch::moe_gmm_bwd", mutates_args=())
def _moe_gmm_bwd_op(x: torch.Tensor, w: torch.Tensor,
                    dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return moe_gmm_bwd_cuda(x, w, dy)
    if x.device.type == "cpu":
        _check(x, w)
        return moe_gmm_bwd_plain(x, w, dy)
    raise NotImplementedError(f"moe_gmm_bwd: no path for device {x.device}")


@_moe_gmm_bwd_op.register_fake
def _(x, w, dy):
    _check(x, w)
    return torch.empty_like(x), torch.empty_like(w)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    x, w = ctx.saved_tensors
    return torch.ops.repro_torch.moe_gmm_bwd(x, w, dy.contiguous().to(x.dtype))


_moe_gmm_op.register_autograd(_backward, setup_context=_setup_context)


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[E, C, D] x [E, D, F] -> [E, C, F]`` per expert, f32 accumulation,
    in x's dtype (``repro/kernels/moe_gmm/ops.py::moe_gmm``; the kernel
    tiles on its own, so there are no block sizes)."""
    return torch.ops.repro_torch.moe_gmm(x.contiguous(), w.contiguous())
