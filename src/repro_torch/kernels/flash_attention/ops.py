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

Training has two more ops.  ``repro_torch::flash_attention_train`` is the
same forward that also returns each row's log-sum-exp ``lse`` (f32
``[B, Hq, Sq]``; the kernel writes it when asked), and its gradient,
registered with ``torch.library.register_autograd``, is
``repro_torch::flash_attention_bwd``: on a CUDA tensor the hand-written
backward kernels (``csrc/flash_bwd.cu``: ``D = rowsum(dO * O)``, dK / dV
over key tiles, dQ over query tiles; bf16 and fp16 on the tensor cores,
the G query heads of a KV head split over a thread-block cluster and summed
in a fixed order, f32 on the CUDA cores; no atomics, the split from
:func:`flash_bwd_splits`) or a raise, on a CPU tensor
:func:`flash_attention_bwd_plain`.  The JAX package has no backward
kernel (XLA differentiates ``chunked_attention``); its gradients are what
the CPU tests hold the plain backward to.  ``models/layers.py`` takes the
training op only where a gradient is being recorded, so serving launches
and counts stay those of ``flash_attention_cuda``.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_bwd_cuda", "flash_attention_bwd_path",
           "flash_attention_bwd_plain", "flash_attention_cuda", "flash_attention_path",
           "flash_attention_plain", "flash_attention_train", "flash_attention_train_cuda",
           "flash_bwd_splits"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HD = (16, 32, 64, 128, 256)
_count_lock = threading.Lock()
# the backward's tensor-core tiling (csrc/flash_bwd.cu)
_BWD_KEY_TILE = 64          # keys per dK / dV CTA
_BWD_SPLITS = (1, 2, 4, 8)  # CTAs of one cluster sharing a key tile's query heads


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
    return _plain_forward(q, k, v, causal, window, q_offset, chunk, q_chunk)[0]


def _plain_forward(q, k, v, causal, window, q_offset, chunk, q_chunk):
    """:func:`flash_attention_plain` and each row's log-sum-exp ``m + log l``
    of its scaled scores (f32 [B, Hq, Sq], the training op's residual)."""
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
    outs, lses = [], []
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
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))                       # [B, q_chunk, Hkv, G]
    lse = torch.stack(lses, dim=1).reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()
    return torch.stack(outs, dim=1).reshape(B, Sq, Hq, hd), lse


def _keep(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    """The forward's mask [Sq, Skv]: key j kept for query row i."""
    qp = q_offset + torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep


def flash_attention_bwd_plain(
    dout: torch.Tensor,   # [B, Sq, Hq, hd]
    q: torch.Tensor,      # [B, Sq, Hq, hd]
    k: torch.Tensor,      # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    out: torch.Tensor,    # the forward's output
    lse: torch.Tensor,    # the forward's f32 [B, Hq, Sq]
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of the forward, as the backward kernel computes it, on
    whole score matrices: ``P = exp(s - lse)`` (0 where masked), ``D =
    rowsum(dO * O)``, ``dS = P * (dO V^T - D)``, ``dq = scale dS K``, ``dk =
    scale dS^T Q`` and ``dv = P^T dO``, the G query heads of a KV head
    summed into its dk / dv.  In f64 (the kernel's f32 sums run in another
    order; against an f64 reference only the kernel's own rounding is
    measured).  Returns ``(dq, dk, dv)`` in the inputs' dtype, contiguous
    as the kernel's and the fake implementation's are (an einsum's result
    may be a permuted view, which a captured graph's ``view`` of it
    refuses)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5
    f64 = torch.float64
    qf = q.to(f64).reshape(B, Sq, Hkv, G, hd)
    dof = dout.to(f64).reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.to(f64), v.to(f64)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    keep = _keep(Sq, Skv, causal, window, q_offset, q.device)
    p = torch.where(keep, torch.exp(s - lse.to(f64).reshape(B, Hkv, G, Sq)[..., None]), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    D = (dout.to(f64) * out.to(f64)).sum(-1).reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("flash_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernels' library, built on first use, with its C
    signature."""
    lib = _build.load("flash_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_path(dtype: torch.dtype) -> str:
    """The kernel form a launch takes, as the C entry point dispatches:
    ``"mma"`` (tensor cores) for bf16 and fp16, ``"simt"`` (f32 CUDA cores)
    for f32, whose TF32 tensor cores would miss the 2e-5 bar."""
    return "simt" if dtype == torch.float32 else "mma"


def flash_attention_bwd_path(dtype: torch.dtype) -> str:
    """The backward's form, as its C entry point dispatches: ``"mma"``
    (tensor cores) for bf16 and fp16, ``"simt"`` (f32 CUDA cores) for f32,
    the forward's ruling (:func:`flash_attention_path`).  Raises on a dtype
    the kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd: unsupported dtype {dtype}")
    return flash_attention_path(dtype)


def flash_bwd_splits(B: int, Skv: int, Hq: int, Hkv: int, sms: int = 132) -> int:
    """The tensor-core backward's split: how many CTAs (one thread-block
    cluster) share a 64-key tile's G = Hq / Hkv query heads, each walking
    G / splits of them and summing its f32 dK / dV into the cluster's in
    rank order.  The smallest of 1, 2, 4, 8 that divides G and brings the
    dK / dV grid (key tiles x Hkv x B x splits) to the card's ``sms`` SMs;
    where none does, the largest that divides G.  Past the SMs more splits
    only add merges."""
    if B < 1 or Skv < 0 or Hq < 1 or Hkv < 1 or Hq % Hkv or sms < 1:
        raise ValueError(f"flash_bwd_splits: B={B} Skv={Skv} Hq={Hq} Hkv={Hkv} sms={sms}")
    G = Hq // Hkv
    fits = [s for s in _BWD_SPLITS if G % s == 0]
    base = -(-Skv // _BWD_KEY_TILE) * Hkv * B
    return next((s for s in fits if base * s >= sms), fits[-1])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: Optional[int]) -> None:
    """The checks that need no device: shapes, head dim, window, dtypes."""
    B, Sq, Hq, hd = q.shape
    Bk, Skv, Hkv, hd_k = k.shape
    if (v.shape != k.shape or Bk != B or hd_k != hd or Hkv == 0 or Hq % Hkv
            or hd not in _HD):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k / v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} (hd in {_HD})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}")


def _check_device(path: str, *named: tuple[str, torch.Tensor]) -> None:
    """Every tensor on the first one's CUDA device and contiguous; the
    tensor-core forms read q, k, v and dout in 16-byte rows."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda: needs CUDA tensors, q is on {dev}")
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if path == "mma" and name in ("q", "k", "v", "dout") and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 / fp16 {name} must be 16-byte aligned")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: Optional[int]) -> str:
    """The forward kernel's input checks; returns its path."""
    _check_args(q, k, v, window)
    path = flash_attention_path(q.dtype)
    _check_device(path, ("q", q), ("k", k), ("v", v))
    return path


def _forward_cuda(q, k, v, causal, window, q_offset, lse) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPE_CODES[q.dtype],
        B, Sq, Skv, Hq, Hkv, hd, int(causal), window if window is not None else 0,
        int(q_offset), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out


def _count(fn, path: str) -> None:
    with _count_lock:
        fn.launches += 1
        fn.launches_by_path[path] += 1


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
    path = _check_cuda(q, k, v, window)
    out = _forward_cuda(q, k, v, causal, window, q_offset, None)
    _count(flash_attention_cuda, path)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = {"mma": 0, "simt": 0}


def flash_attention_train_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: :func:`flash_attention_cuda`'s kernel asked for
    each row's log-sum-exp as well.  Returns ``(out, lse f32 [B, Hq, Sq])``.
    Counts in ``flash_attention_train_cuda.launches`` (and per path), not in
    the serving counts."""
    path = _check_cuda(q, k, v, window)
    B, Sq, Hq, _ = q.shape
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    out = _forward_cuda(q, k, v, causal, window, q_offset, lse)
    _count(flash_attention_train_cuda, path)
    return out, lse


flash_attention_train_cuda.launches = 0
flash_attention_train_cuda.launches_by_path = {"mma": 0, "simt": 0}


def flash_attention_bwd_cuda(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (``csrc/flash_bwd.cu``: the ``D`` pass,
    dK / dV, dQ, in order on the current stream): bf16 and fp16 on the
    tensor cores, split by :func:`flash_bwd_splits` for this card's SMs, f32
    on the CUDA cores (:func:`flash_attention_bwd_path`).  ``out`` and
    ``lse`` are the training forward's.  Checks shapes, head dim and dtypes
    first, then device, contiguity and alignment, and raises on anything
    the kernels do not take, and on a refused launch.  Returns ``(dq, dk,
    dv)`` in the inputs' dtype.  Counts one call in
    ``flash_attention_bwd_cuda.launches`` (its three kernels are one
    backward) and one in ``flash_attention_bwd_cuda.launches_by_path``."""
    _check_args(q, k, v, window)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or out.shape != q.shape or dout.dtype != q.dtype \
            or out.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} {dout.dtype} / out "
                         f"{tuple(out.shape)} {out.dtype} do not fit q {tuple(q.shape)}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 {(B, Hq, Sq)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    path = flash_attention_bwd_path(q.dtype)
    _check_device(path, ("q", q), ("k", k), ("v", v), ("dout", dout), ("out", out),
                  ("lse", lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    splits = flash_bwd_splits(B, Skv, Hq, Hkv, _sm_count(q.device.index or 0))
    D = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODES[q.dtype], B, Sq, Skv, Hq, Hkv, hd, int(causal),
        window if window is not None else 0, int(q_offset), hd ** -0.5, splits, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    _count(flash_attention_bwd_cuda, path)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_path = {"mma": 0, "simt": 0}


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


@torch.library.custom_op("repro_torch::flash_attention_train", mutates_args=())
def _flash_attention_train_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    window: Optional[int],
    q_offset: int,
    chunk: int,
    q_chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    if q.is_cuda:
        return flash_attention_train_cuda(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, window, q_offset, chunk, q_chunk)
    raise NotImplementedError(f"flash_attention_train: no path for device {q.device}")


@_flash_attention_train_op.register_fake
def _(q, k, v, causal, window, q_offset, chunk, q_chunk):
    B, Sq, Hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, Sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_op(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    causal: bool,
    window: Optional[int],
    q_offset: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.is_cuda:
        return flash_attention_bwd_cuda(dout, q, k, v, out, lse, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal, window, q_offset)
    raise NotImplementedError(f"flash_attention_bwd: no path for device {q.device}")


@_flash_attention_bwd_op.register_fake
def _(dout, q, k, v, out, lse, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _train_setup_context(ctx, inputs, output):
    q, k, v, causal, window, q_offset, _chunk, _q_chunk = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.args = (causal, window, q_offset)


def _train_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(dout.contiguous(), q, k, v, out, lse,
                                                            *ctx.args)
    return dq, dk, dv, None, None, None, None, None


_flash_attention_train_op.register_autograd(_train_backward, setup_context=_train_setup_context)


def flash_attention_train(
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
    """:func:`flash_attention` through the training op, which autograd
    differentiates with the backward kernel (``repro_torch::
    flash_attention_bwd``).  Returns the attention output; the log-sum-exp
    stays an internal residual of the op."""
    return torch.ops.repro_torch.flash_attention_train(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal), window, int(q_offset),
        int(chunk), int(q_chunk))[0]


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
