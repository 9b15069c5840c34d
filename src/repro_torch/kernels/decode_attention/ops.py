"""Paged decode attention: the dispatching op, its CUDA wrapper and its
plain PyTorch version.

``paged_decode_attention`` is registered as the custom op
``repro_torch::paged_decode_attention`` (with a fake implementation), so
capture sees the whole call as one graph node.  Inside the op the device
decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/paged_decode.cu``, replacing the TPU kernel
  ``repro/kernels/decode_attention/kernel.py::paged_decode_attention_kernel_call``)
  or raises — there is no fallback;
* a CPU tensor takes :func:`paged_decode_attention_plain`, the op-for-op
  twin of the JAX package's gather path (``decode_attention/ops.py``), so
  the CPU tests hold the port to the reference.

The kernel is bound by the bytes of the pages it reads; at serving sizes it
is bound by its launch.  Its design and what it leaves on the table are in
the source.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = [
    "paged_decode_attention",
    "paged_decode_attention_cuda",
    "paged_decode_attention_plain",
]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()


def paged_decode_attention_plain(
    q: torch.Tensor,           # [B, Hq, hd]
    k_pages: torch.Tensor,     # [P, ps, Hkv, hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, n_pt] int32, -1 = unmapped
    q_pos: torch.Tensor,       # [B] int32
    window: Optional[int] = None,
) -> torch.Tensor:
    """Gather the pages by table, then the position-masked softmax —
    op for op the JAX package's jnp path, including where it rounds to the
    working dtype (the scaled query, the scores, the probabilities)."""
    B, Hq, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    n_pt = page_table.shape[1]
    clamped = page_table.clamp(min=0).long()
    kc = k_pages[clamped].reshape(B, n_pt * ps, Hkv, hd)
    vc = v_pages[clamped].reshape(B, n_pt * ps, Hkv, hd)
    idx = torch.arange(n_pt * ps, device=q.device)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)
    kv_pos = torch.where(mapped, idx[None], -1)
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd) * hd ** -0.5
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc).float()
    qp = q_pos[:, None]
    keep = (kv_pos >= 0) & (kv_pos <= qp)
    if window is not None:
        keep = keep & (kv_pos > qp - window)
    s = torch.where(keep[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(vc.dtype), vc)
    return out.reshape(B, Hq, hd).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def paged_decode_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    q_pos: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (the executor's).

    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take; raises on a refused launch.  Counts one in
    ``paged_decode_attention_cuda.launches`` per launch.  Rows with no
    mapped page come back as zeros."""
    B, Hq, hd = q.shape
    P, ps, Hkv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd or Hq % Hkv:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or tuple(q_pos.shape) != (B,):
        raise ValueError(f"paged_decode_attention: table {tuple(page_table.shape)} / "
                         f"q_pos {tuple(q_pos.shape)} do not match batch {B}")
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("q_pos", q_pos)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: unsupported dtypes q={q.dtype} "
                        f"k={k_pages.dtype} v={v_pages.dtype}")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and q_pos must be int32")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], B, Hq, Hkv, hd, P, ps,
        page_table.shape[1], window if window is not None else 0, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


@torch.library.custom_op("repro_torch::paged_decode_attention", mutates_args=())
def _paged_decode_attention_op(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    q_pos: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages, page_table, q_pos, window)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, q_pos, window)
    raise NotImplementedError(f"paged_decode_attention: no path for device {q.device}")


@_paged_decode_attention_op.register_fake
def _(q, k_pages, v_pages, page_table, q_pos, window):
    return torch.empty_like(q)


def paged_decode_attention(
    q: torch.Tensor,           # [B, 1, Hq, hd] (model layout) or [B, Hq, hd]
    k_pages: torch.Tensor,     # [P, ps, Hkv, hd] global page pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, n_pt] physical page ids, -1 = unmapped
    q_pos: torch.Tensor,       # [B] absolute position per row
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token GQA attention over a page pool through a page table.

    The logical position of table entry ``(j, t)`` is ``j*ps + t``; entries
    of unmapped pages, past ``q_pos`` or outside the window are masked.
    Returns q's layout and dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    out = torch.ops.repro_torch.paged_decode_attention(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        page_table.to(torch.int32).contiguous(), q_pos.to(torch.int32).contiguous(), window)
    return out[:, None] if squeeze else out
