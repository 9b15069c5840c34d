"""Decode attention: single-token GQA over a KV cache, in two layouts.

* **Paged** — ``paged_decode_attention`` (custom op
  ``repro_torch::paged_decode_attention``) reads a global page pool through
  a page table; CUDA tensors launch ``csrc/paged_decode.cu`` (replacing
  ``repro/kernels/decode_attention/kernel.py::paged_decode_attention_kernel_call``).
* **Dense** — ``decode_attention`` (custom op
  ``repro_torch::decode_attention``) reads a dense (linear or ring) cache
  whose entries carry a position table, shared ``kv_pos [S]`` with a scalar
  ``q_pos`` (the wave engine) or per row ``kv_pos [B, S]`` with ``q_pos
  [B]`` (the slot engine); CUDA tensors launch ``csrc/dense_decode.cu``
  (replacing ``...kernel.py::decode_attention_kernel_call``), one kernel
  for both forms.

Each op has a fake implementation, so capture sees the whole call as one
graph node.  Inside the op the device decides: a CUDA tensor launches the
hand-written Hopper kernel or raises — there is no fallback; a CPU tensor
takes the plain PyTorch version (``*_plain``), op for op the JAX package's
jnp path, so the CPU tests hold the port to the reference.

Both kernels are one split-K core (``csrc/decode_core.cuh``): a
thread-block cluster of ``n_c`` CTAs per (row, KV head) splits the row's
entries, streams them through a ``cp.async`` ring and merges its splits in
distributed shared memory, in one launch.  ``decode_split`` picks ``n_c``
and the chunk per pipeline stage from the static sizes.  The design and
what it leaves on the table are in the core's source.
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
    "decode_attention",
    "decode_attention_cuda",
    "decode_attention_plain",
    "decode_split",
    "paged_decode_attention",
    "paged_decode_attention_cuda",
    "paged_decode_attention_plain",
]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()

# the core's limits (csrc/decode_core.cuh)
_CORE_HD = (16, 32, 64, 128, 256)   # head dims instantiated; a smaller hd pads up
_MAX_SMEM = 232448                  # shared memory a CTA may opt in to (227 KB)
_MAX_CLUSTER = 8                    # portable cluster size
_MAX_HEADS = 8                      # query heads per CTA (more: other CTAs)
_META = 1024                        # entries whose metadata a CTA holds at once
_PAD = 16                           # bytes of padding per staged row


def core_smem(chunk: int, itemsize: int, HD: int) -> int:
    """Shared memory of one CTA of the core, in bytes, as the kernel lays it
    out: two stages of K and V chunks, the accumulator of 8 heads, the
    scores, the probabilities, three floats per head, the metadata window,
    its chunk flags and a flag word."""
    ld = HD + _PAD // itemsize
    return (4 * chunk * ld * itemsize + 4 * _MAX_HEADS * HD + 4 * 64 * _MAX_HEADS
            + 4 * 64 * _MAX_HEADS + 4 * 3 * _MAX_HEADS + 4 * _META + 4 * (_META // 32) + 16)


def decode_split(n_entries: int, itemsize: int, hd: int, clusters: int = 1,
                 sms: int = 132) -> tuple[int, int]:
    """``(n_c, chunk)`` for the decode core: the chunk of entries per
    pipeline stage (64, or 32 where two stages of 64 do not fit 227 KB, as
    at f32 and hd 256) and the CTAs per cluster: at most 8, no more than the
    largest row has chunks (so every CTA has work there), and no more than
    fill two CTAs on each of the card's ``sms`` SMs across the launch's
    ``clusters`` (one per row, KV head and group of 8 query heads): past
    that, a CTA's fixed cost (metadata, merge) outweighs its share of the
    row.  ``n_entries`` is the most entries a row can hold: S for a dense
    cache, ``n_pt * ps`` for a paged one."""
    HD = next((h for h in _CORE_HD if hd <= h), None)
    if HD is None or hd < 1:
        raise ValueError(f"decode core: head dim {hd} not in 1..{_CORE_HD[-1]}")
    chunk = next((c for c in (64, 32) if core_smem(c, itemsize, HD) <= _MAX_SMEM), None)
    if chunk is None:
        raise ValueError(f"decode core: hd {hd} with {itemsize}-byte elements does not "
                         f"fit {_MAX_SMEM} bytes of shared memory")
    return max(1, min(_MAX_CLUSTER, -(-n_entries // chunk), 2 * sms // max(clusters, 1))), chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_for(q: torch.Tensor, n_entries: int, Hkv: int) -> tuple[int, int]:
    """``decode_split`` for a launch on q's card."""
    B, Hq, hd = q.shape
    groups = -(-(Hq // Hkv) // _MAX_HEADS)
    return decode_split(n_entries, q.element_size(), hd, B * Hkv * groups,
                        _sm_count(q.device.index if q.device.index is not None else 0))


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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
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
    ``paged_decode_attention_cuda.launches`` per launch.  Takes any hd up to
    256.  A row that keeps no entry comes back as the plain version gives
    it: the mean of V over the entries its table gathers."""
    B, Hq, hd = q.shape
    P, ps, Hkv, hd_k = k_pages.shape
    if (v_pages.shape != k_pages.shape or hd_k != hd or Hkv == 0 or Hq % Hkv
            or not 1 <= hd <= _CORE_HD[-1]):
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
    n_pt = page_table.shape[1]
    n_c, chunk = _split_for(q, n_pt * ps, Hkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], B, Hq, Hkv, hd, P, ps,
        n_pt, n_c, chunk, window if window is not None else 0, hd ** -0.5, stream)
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


# ---------------------------------------------------------------------------
# dense cache: kv_pos [S] + q_pos [] (shared) or kv_pos [B, S] + q_pos [B]
# ---------------------------------------------------------------------------

def decode_attention_plain(
    q: torch.Tensor,        # [B, Hq, hd]
    k_cache: torch.Tensor,  # [B, S, Hkv, hd] (linear or ring buffer)
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,   # [S] | [B, S] absolute position per entry; -1 = empty
    q_pos: torch.Tensor,    # [] | [B] absolute position of the query token
    window: Optional[int] = None,
) -> torch.Tensor:
    """Slot-position-masked softmax over the whole cache — op for op the JAX
    package's ``layers.decode_attention``, including where it rounds to the
    working dtype (the scaled query, the scores, the probabilities).  A row
    with no kept entry gets the uniform average of its cache, as there."""
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd) * hd ** -0.5
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache).float()
    if kv_pos.dim() == 2:
        qp = q_pos[:, None]
        keep = (kv_pos >= 0) & (kv_pos <= qp)
        if window is not None:
            keep = keep & (kv_pos > qp - window)
        keep = keep[:, None, None, :]
    else:
        keep = (kv_pos >= 0) & (kv_pos <= q_pos)
        if window is not None:
            keep = keep & (kv_pos > q_pos - window)
        keep = keep[None, None, None, :]
    s = torch.where(keep, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, Hq, hd).to(q.dtype)


@functools.cache
def _dense_lib() -> ctypes.CDLL:
    """The dense kernel's library, built on first use, with its C signature."""
    lib = _build.load("dense_decode")
    fn = lib.dense_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,
    q_pos: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (the executor's).

    Takes both forms: ``kv_pos [S]`` with ``q_pos []`` or ``kv_pos [B, S]``
    with ``q_pos [B]``, and any hd up to 256 whose rows are whole 16-byte
    vectors (hd % 8 == 0 in bf16 / fp16, hd % 4 == 0 in f32).  Checks
    device, dtype, shape and contiguity and raises on anything the kernel
    does not take; raises on a refused launch.  Counts one in ``decode_attention_cuda.launches`` per call that
    launches, and one in ``decode_attention_cuda.launches_by_form["shared"
    | "per_row"]``.  A row with no kept entry gets the mean of V over its
    whole cache, as the plain version's all-masked softmax gives it."""
    B, Hq, hd = q.shape
    Bk, S, Hkv, hd_k = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or hd_k != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if not (1 <= hd <= _CORE_HD[-1] and (hd * q.element_size()) % 16 == 0):
        raise ValueError(f"decode_attention: hd {hd} must be <= {_CORE_HD[-1]} with "
                         f"16-byte rows ({q.dtype})")
    per_row = kv_pos.dim() == 2
    if per_row:
        ok = tuple(kv_pos.shape) == (B, S) and tuple(q_pos.shape) == (B,)
    else:
        ok = tuple(kv_pos.shape) == (S,) and q_pos.dim() == 0
    if not ok:
        raise ValueError(f"decode_attention: kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} are neither [S] / [] nor [B, S] / [B] "
                         f"(B={B}, S={S})")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1, got {window}")
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"decode_attention_cuda: needs CUDA tensors, q is on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_pos", kv_pos), ("q_pos", q_pos)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: unsupported dtypes q={q.dtype} "
                        f"k={k_cache.dtype} v={v_cache.dtype}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("decode_attention: kv_pos and q_pos must be int32")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    n_c, chunk = _split_for(q, S, Hkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _dense_lib().dense_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_pos.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], B, S, Hq, Hkv, hd,
        int(per_row), int(per_row), n_c, chunk, window if window is not None else 0,
        hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        decode_attention_cuda.launches += 1
        decode_attention_cuda.launches_by_form["per_row" if per_row else "shared"] += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_form = {"shared": 0, "per_row": 0}


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_op(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,
    q_pos: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, kv_pos, q_pos, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_pos, q_pos, window)
    raise NotImplementedError(f"decode_attention: no path for device {q.device}")


@_decode_attention_op.register_fake
def _(q, k_cache, v_cache, kv_pos, q_pos, window):
    return torch.empty_like(q)


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, hd] (model layout) or [B, Hq, hd]
    k_cache: torch.Tensor,  # [B, S, Hkv, hd]
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,   # [S] | [B, S]; -1 = empty
    q_pos: torch.Tensor,    # [] | [B]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token GQA attention against a dense KV cache.

    Slot-position masking serves linear caches (kv_pos = 0..len-1, rest -1)
    and ring buffers (entry s holds position kv_pos[s]); the 2-D form is the
    per-slot layout where every row decodes at its own position.  Returns
    q's layout and dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    out = torch.ops.repro_torch.decode_attention(
        q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
        kv_pos.to(torch.int32).contiguous(), q_pos.to(torch.int32).contiguous(), window)
    return out[:, None] if squeeze else out
