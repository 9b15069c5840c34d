"""RG-LRU linear recurrence (recurrentgemma's Griffin blocks): the
dispatching op, its CUDA wrapper and its plain PyTorch version.

``rglru_scan(a, b, h0=None)`` takes the reference's layout: decay and input
``a, b [B, S, R]`` (f32) and an optional starting state ``h0 [B, R]`` (f32;
zero when absent, as the TPU kernel starts).  It returns ``(hs [B, S, R]
f32, h_last [B, R] f32)`` with ``h_t = a_t·h_{t-1} + b_t``: the whole
sequence of states is the output.  Taking ``h0`` is what lets a decode
step (``S = 1``, ``h0`` = the cached state) use the same op as the
prefill.  It is registered as the custom op ``repro_torch::rglru_scan``
(with a fake implementation), so capture sees one graph node per scan.
Inside the op the device decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/rglru_scan.cu``, replacing the TPU kernel
  ``repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel_call``) or raises
  — there is no fallback.  It takes any B, S and R (the TPU kernel needs
  block sizes that tile R and S); :func:`scan_tiles` picks its tiling;
* a CPU tensor takes :func:`rglru_scan_plain`, op for op the JAX package's
  ``rglru_scan_ref``, so the CPU tests hold the port to the reference.

Its gradient is registered with ``torch.library.register_autograd``: the
op ``repro_torch::rglru_scan_bwd`` walks the reverse chain ``dh_t = dhs_t
+ a_{t+1}·dh_{t+1}`` from the ``h_last`` cotangent and returns ``(da, db,
dh0)`` (``da_t = dh_t·h_{t-1}`` from the saved ``hs``, ``db_t = dh_t``,
``dh0 = a_0·dh_0``).  On a CUDA tensor it is the hand-written kernel
``rglru_scan_bwd`` beside the forward in ``csrc/rglru_scan.cu`` (or a
raise), bit-equal to :func:`rglru_scan_bwd_plain`, which a CPU tensor
takes: ``jax.vjp`` of ``rglru_scan_ref`` step by step.  The JAX package
has no backward kernel (XLA differentiates its jnp recurrence).
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

__all__ = ["ScanTiles", "ring_bytes", "rglru_scan", "rglru_scan_bwd_cuda",
           "rglru_scan_bwd_plain", "rglru_scan_cuda", "rglru_scan_plain", "scan_tiles"]

_count_lock = threading.Lock()
MAX_SMEM = 232448          # shared memory an H100 CTA may opt in to
_CHANNELS = (32, 16, 8)    # one chain warp: a lane per channel (the kernel's widths, and 4)
_STAGES = 4
_RING = 64 * 1024          # ring bytes a CTA keeps to, so three CTAs fit an SM
_STEP = 8                  # chunks are multiples of 8 steps


class ScanTiles(NamedTuple):
    """The kernel's tiling: ``channels`` per CTA (0 = the direct form, one
    thread per channel and no staging), ``chunk`` steps per ring stage and
    ``stages`` stages."""
    channels: int
    chunk: int
    stages: int


def ring_bytes(channels: int, chunk: int, stages: int) -> int:
    """Shared memory of one CTA of the staged form, as the kernel lays it
    out: a [chunk x channels] tile of a and one of b a stage, f32, then
    two mbarriers a stage."""
    return stages * (16 + 2 * chunk * channels * 4)


def scan_tiles(B: int, S: int, R: int, sms: int = 132) -> ScanTiles:
    """The tiling of one launch.  S = 1 (a decode step) takes the direct
    form: nothing to stream.  Otherwise a CTA takes the widest block of
    channels the kernel has (32, 16, 8; multiples of 4, so the copies can
    be 16 bytes) that still gives every one of the card's ``sms`` SMs a
    CTA across the B rows, or 4 where none does.  A stage holds 128 steps
    from S = 256 on, 64 below that (fewer, rounded up to 8, for S < 64),
    and the ring 4 stages, or as many as fit 64 KB (so three CTAs fit an
    SM).  ``scripts/torch_scan_trace.py`` sweeps the alternatives at
    recurrentgemma-2b's prefills."""
    if S == 1:
        return ScanTiles(0, 0, 0)
    channels = next((c for c in _CHANNELS if B * -(-R // c) >= sms), 4)
    chunk = 128 if S >= 256 else 64 if S >= 64 else -(-S // _STEP) * _STEP
    return ScanTiles(channels, chunk, max(1, min(_STAGES, _RING // (2 * chunk * channels * 4))))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A step-by-step loop over S in f32 — ``rglru_scan_ref`` (``h0``
    absent: zeros).  Returns ``(hs [B, S, R], h_last [B, R])``."""
    a, b = a.float(), b.float()
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else a.new_zeros((B, 0, R))), h


def rglru_scan_bwd_plain(a: torch.Tensor, hs: torch.Tensor, h0: Optional[torch.Tensor],
                         dhs: torch.Tensor,
                         dh_last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse chain in f32, step by step — ``jax.vjp`` of
    ``rglru_scan_ref``: from ``g = dh_last``, for t = S-1 .. 0, ``g = dhs_t +
    g``, ``da_t = g·h_{t-1}``, ``db_t = g``, ``g = g·a_t``.  ``hs`` is the
    forward's output (``h_{t-1} = hs[:, t-1]``, ``h0`` or zero at t = 0).
    Returns ``(da, db [B, S, R] in a's dtype, dh0 [B, R] f32)``."""
    a32, hs, dhs = a.float(), hs.float(), dhs.float()
    B, S, R = a.shape
    g = dh_last.float()
    first = torch.zeros((B, R), dtype=torch.float32, device=a.device) if h0 is None \
        else h0.float()
    da = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    for t in reversed(range(S)):
        g = dhs[:, t] + g
        da[:, t] = g * (hs[:, t - 1] if t > 0 else first)
        db[:, t] = g
        g = g * a32[:, t]
    return da.to(a.dtype), db.to(a.dtype), g


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bwd = lib.rglru_scan_bwd
    bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b must be [B, S, R], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    B, _, R = a.shape
    if h0 is not None and h0.shape != (B, R):
        raise ValueError(f"rglru_scan: h0 must be [B, R] = {(B, R)}, got {tuple(h0.shape)}")


def _check_cuda(a: torch.Tensor, named: list) -> None:
    """The kernels' device, layout and dtype checks on ``(name, tensor)``."""
    if not a.is_cuda:
        raise ValueError(f"rglru_scan_cuda: needs CUDA tensors, a is on {a.device}")
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} has unsupported dtype {t.dtype} (float32)")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (the executor's).

    ``a, b [B, S, R]`` and ``h0 [B, R]``, all f32 and contiguous on one
    card.  Raises on anything the kernel does not take and on a refused
    launch.  Counts one in ``rglru_scan_cuda.launches`` per launch."""
    _check(a, b, h0)
    B, S, R = a.shape
    _check_cuda(a, [("a", a), ("b", b)] + ([] if h0 is None else [("h0", h0)]))
    hs = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    if B * S * R == 0:
        h_last = (torch.zeros((B, R), dtype=torch.float32, device=a.device) if h0 is None
                  else h0.clone())
        return hs, h_last
    h_last = torch.empty((B, R), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tiles = scan_tiles(B, S, R, _sm_count(a.device.index if a.device.index is not None else 0))
    err = _lib().rglru_scan_fwd(a.data_ptr(), b.data_ptr(),
                                None if h0 is None else h0.data_ptr(), hs.data_ptr(),
                                h_last.data_ptr(), B, S, R, *tiles, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    with _count_lock:
        rglru_scan_cuda.launches += 1
    return hs, h_last


rglru_scan_cuda.launches = 0


def rglru_scan_bwd_cuda(a: torch.Tensor, hs: torch.Tensor, h0: Optional[torch.Tensor],
                        dhs: torch.Tensor,
                        dh_last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (``rglru_scan_bwd`` in
    ``csrc/rglru_scan.cu``) on the current stream: ``a``, the forward's
    ``hs`` and the cotangent ``dhs`` ``[B, S, R]``, ``h0`` and ``dh_last``
    ``[B, R]``, all f32 and contiguous on one card.  Returns ``(da, db,
    dh0)``.  Raises on anything the kernel does not take and on a refused
    launch.  Counts one in ``rglru_scan_bwd_cuda.launches`` per launch."""
    _check(a, hs, h0)
    B, S, R = a.shape
    if dhs.shape != a.shape or dh_last.shape != (B, R):
        raise ValueError(f"rglru_scan_bwd: dhs must be {tuple(a.shape)} and dh_last {(B, R)}, "
                         f"got {tuple(dhs.shape)} and {tuple(dh_last.shape)}")
    _check_cuda(a, [("a", a), ("hs", hs), ("dhs", dhs), ("dh_last", dh_last)]
                + ([] if h0 is None else [("h0", h0)]))
    da = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    if B * S * R == 0:
        return da, db, dh_last.clone()
    dh0 = torch.empty((B, R), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rglru_scan_bwd(a.data_ptr(), hs.data_ptr(),
                                None if h0 is None else h0.data_ptr(), dhs.data_ptr(),
                                dh_last.data_ptr(), da.data_ptr(), db.data_ptr(), dh0.data_ptr(),
                                B, S, R, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        rglru_scan_bwd_cuda.launches += 1
    return da, db, dh0


rglru_scan_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan_op(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    if a.is_cuda:
        return rglru_scan_cuda(a, b, h0)
    if a.device.type == "cpu":
        _check(a, b, h0)
        return rglru_scan_plain(a, b, h0)
    raise NotImplementedError(f"rglru_scan: no path for device {a.device}")


@_rglru_scan_op.register_fake
def _(a, b, h0):
    B, S, R = a.shape
    f32 = torch.float32
    return a.new_empty((B, S, R), dtype=f32), a.new_empty((B, R), dtype=f32)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _rglru_scan_bwd_op(a: torch.Tensor, hs: torch.Tensor, h0: Optional[torch.Tensor],
                       dhs: torch.Tensor,
                       dh_last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if a.is_cuda:
        return rglru_scan_bwd_cuda(a, hs, h0, dhs, dh_last)
    if a.device.type == "cpu":
        _check(a, hs, h0)
        return rglru_scan_bwd_plain(a, hs, h0, dhs, dh_last)
    raise NotImplementedError(f"rglru_scan_bwd: no path for device {a.device}")


@_rglru_scan_bwd_op.register_fake
def _(a, hs, h0, dhs, dh_last):
    B, S, R = a.shape
    return a.new_empty((B, S, R)), a.new_empty((B, S, R)), \
        a.new_empty((B, R), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    a, b, h0 = inputs
    ctx.b_dtype = b.dtype
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(a, output[0], h0)


def _backward(ctx, dhs, dh_last):
    a, hs, h0 = ctx.saved_tensors
    da, db, dh0 = torch.ops.repro_torch.rglru_scan_bwd(
        a, hs, h0, dhs.contiguous().float(), dh_last.contiguous().float())
    return da, db.to(ctx.b_dtype), (dh0.to(h0.dtype) if ctx.has_h0 else None)


_rglru_scan_op.register_autograd(_backward, setup_context=_setup_context)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence over the reference's layout
    (``repro/kernels/rglru_scan/ops.py::rglru_scan``, plus an optional
    ``h0``; the kernel tiles on its own, so there are no block sizes).
    Returns ``(hs, h_last)``, both f32."""
    return torch.ops.repro_torch.rglru_scan(a.contiguous(), b.contiguous(),
                                            None if h0 is None else h0.contiguous())
