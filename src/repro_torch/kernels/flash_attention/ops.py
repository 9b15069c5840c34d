"""Flash attention (GQA forward, causal / sliding window): the dispatching
op, its CUDA wrapper and its plain PyTorch version.

``flash_attention`` is registered as the custom op
``repro_torch::flash_attention`` (with a fake implementation), so capture
sees the whole call as one graph node.  It takes the model's layout
``[B, S, H, hd]``.  Inside the op the device decides:

* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/flash_fwd.cu``, replacing the TPU kernel
  ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel_call``)
  or raises — there is no fallback.  bf16 and fp16 run on the tensor cores,
  f32 on the CUDA cores (:func:`flash_attention_path`).  It reads the model
  layout in place (the JAX wrapper transposes to ``[B, H, S, hd]`` first)
  and masks ragged sequence lengths itself;
* a CPU tensor takes :func:`flash_attention_plain`, op for op the JAX
  package's ``layers.chunked_attention`` (online softmax over KV chunks of
  ``chunk`` and Q blocks of ``q_chunk``), so the CPU tests hold the port to
  the reference.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_path",
           "flash_attention_plain"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HD = (16, 32, 64, 128, 256)
_count_lock = threading.Lock()


def flash_attention_plain(
    q: torch.Tensor,   # [B, Sq, Hq, hd]
    k: torch.Tensor,   # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 2048,
    q_chunk: int = 2048,
) -> torch.Tensor:
    """GQA attention, online softmax over KV chunks and blocked over Q
    chunks — op for op ``layers.chunked_attention``: the same chunk
    fallbacks (a chunk that does not divide the length becomes the whole
    length), the same rounding of the scaled query, scores and
    probabilities to the working dtype, f32 state.  Returns [B, Sq, Hq, hd]."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"n_heads {Hq} not a multiple of n_kv_heads {Hkv}")
    G = Hq // Hkv
    if chunk <= 0 or Skv % chunk != 0:
        chunk = Skv
    n_kv = Skv // chunk
    if q_chunk <= 0 or Sq % q_chunk != 0:
        q_chunk = Sq
    n_q = Sq // q_chunk
    dev = q.device

    qg = q.reshape(B, n_q, q_chunk, Hkv, G, hd) * hd ** -0.5
    kc = k.reshape(B, n_kv, chunk, Hkv, hd)
    vc = v.reshape(B, n_kv, chunk, Hkv, hd)
    outs = []
    for qi in range(n_q):
        qb = qg[:, qi]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, q_chunk, Hkv, G, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, q_chunk, Hkv, G), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, q_chunk, Hkv, G), dtype=torch.float32, device=dev)
        for ci in range(n_kv):
            kb, vb = kc[:, ci], vc[:, ci]
            kv_pos = ci * chunk + torch.arange(chunk, device=dev)
            keep = torch.ones((q_chunk, chunk), dtype=torch.bool, device=dev)
            if causal:
                keep = keep & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                keep = keep & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.einsum("bqhgd,bchd->bqhgc", qb, kb).float()
            s = torch.where(keep[None, :, None, None, :], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqhgc,bchd->bqhgd", p.to(kb.dtype), vb).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, Sq, Hq, hd)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("flash_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_path(dtype: torch.dtype) -> str:
    """The kernel form a launch takes, as the C entry point dispatches:
    ``"mma"`` (tensor cores) for bf16 and fp16, ``"simt"`` (f32 CUDA cores)
    for f32, whose TF32 tensor cores would miss the 2e-5 bar."""
    return "simt" if dtype == torch.float32 else "mma"


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (the executor's).

    Model layout ``[B, S, H, hd]``, any ``Sq`` and ``Skv`` (ragged tiles are
    masked in the kernel).  Checks device, dtype, shape and contiguity and
    raises on anything the kernel does not take (the tensor-core form reads
    16-byte aligned rows); raises on a refused launch.  Counts one in
    ``flash_attention_cuda.launches`` per launch, and one in
    ``flash_attention_cuda.launches_by_path[flash_attention_path(q.dtype)]``.
    Rows with no kept key come back as zeros."""
    B, Sq, Hq, hd = q.shape
    Bk, Skv, Hkv, hd_k = k.shape
    if (v.shape != k.shape or Bk != B or hd_k != hd or Hkv == 0 or Hq % Hkv
            or hd not in _HD):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k / v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} (hd in {_HD})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda: needs CUDA tensors, q is on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}")
    path = flash_attention_path(q.dtype)
    if path == "mma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 / fp16 q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
        B, Sq, Skv, Hq, Hkv, hd, int(causal), window if window is not None else 0,
        int(q_offset), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        flash_attention_cuda.launches += 1
        flash_attention_cuda.launches_by_path[path] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = {"mma": 0, "simt": 0}


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    window: Optional[int],
    q_offset: int,
    chunk: int,
    q_chunk: int,
) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset, chunk, q_chunk)
    raise NotImplementedError(f"flash_attention: no path for device {q.device}")


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset, chunk, q_chunk):
    return torch.empty_like(q)


def flash_attention(
    q: torch.Tensor,   # [B, Sq, Hq, hd] (model layout)
    k: torch.Tensor,   # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 2048,
    q_chunk: int = 2048,
) -> torch.Tensor:
    """GQA attention with causal and sliding-window masking; ``q_offset`` is
    the absolute position of ``q[:, 0]``.  ``chunk`` / ``q_chunk`` are the
    plain version's blocking (the reference's ``cfg.attn_chunk`` /
    ``cfg.attn_q_chunk``); the kernel tiles on its own.  Returns q's layout
    and dtype."""
    return torch.ops.repro_torch.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal), window, int(q_offset),
        int(chunk), int(q_chunk))
