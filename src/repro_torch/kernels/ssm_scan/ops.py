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

No backward is registered yet, so differentiating through the op raises:
training of the Mamba family waits for this kernel's backward (ROADMAP
A16); ``models.transformer.forward`` refuses the family until then.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["ssm_scan", "ssm_scan_cuda", "ssm_scan_plain"]

_C_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STATE = 32
_count_lock = threading.Lock()


def ssm_scan_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A step-by-step loop over S in f32 — ``ssm_scan_ref`` (``h0`` absent:
    zeros).  Returns ``(y [B, S, D], h_last [B, D, St])``."""
    a, b, c = a.float(), b.float(), c.float()
    B, S, D, St = a.shape
    h = (torch.zeros((B, D, St), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
    y = torch.stack(ys, dim=1) if ys else a.new_zeros((B, 0, D))
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
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


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (the executor's).

    ``a, b [B, S, D, St]`` and ``h0 [B, D, St]`` in f32, ``c [B, S, St]``
    in f32 or bf16, all contiguous on one card, ``1 <= St <= 32``.  Raises
    on anything the kernel does not take and on a refused launch.  Counts
    one in ``ssm_scan_cuda.launches`` per launch."""
    if not a.is_cuda:
        raise ValueError(f"ssm_scan_cuda: needs CUDA tensors, a is on {a.device}")
    _check(a, b, c, h0)
    B, S, D, St = a.shape
    if not 1 <= St <= _MAX_STATE:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= St <= {_MAX_STATE}, got St={St}")
    named = [("a", a), ("b", b), ("c", c)] + ([] if h0 is None else [("h0", h0)])
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")
        if t.dtype != torch.float32 and not (name == "c" and t.dtype in _C_DTYPE_CODES):
            raise TypeError(f"ssm_scan: {name} has unsupported dtype {t.dtype} "
                            "(float32; c also bfloat16)")
    y = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    if B * S * D == 0:
        h_last = (torch.zeros((B, D, St), dtype=torch.float32, device=a.device) if h0 is None
                  else h0.clone())
        return y, h_last
    h_last = torch.empty((B, D, St), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().ssm_scan_fwd(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), _C_DTYPE_CODES[c.dtype], B, S, D, St, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    with _count_lock:
        ssm_scan_cuda.launches += 1
    return y, h_last


ssm_scan_cuda.launches = 0


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


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over the reference's layout
    (``repro/kernels/ssm_scan/ops.py::ssm_scan``, plus an optional ``h0``;
    the kernel tiles on its own, so there are no block sizes).  Returns
    ``(y, h_last)``, both f32."""
    return torch.ops.repro_torch.ssm_scan(a.contiguous(), b.contiguous(), c.contiguous(),
                                          None if h0 is None else h0.contiguous())
