"""Slot assignment of MoE routing: the dispatching op, its CUDA wrapper and
its plain PyTorch version.

``route_slots(expert_idx, n_experts, capacity)`` takes the router's choices
``expert_idx [G, Tg, k]`` (int64) and returns, for the claims in the
reference's rank-major order (every token's first choice in token order,
then every second choice, ...; a claim's slot is the number of earlier
claims on its expert):

* ``positions [G, Tg, k]`` int64: the slot, ``capacity`` where dropped;
* ``keep [G, Tg, k]`` bool: the slot is under ``capacity``;
* ``slot_tok [G, E, capacity + 1]`` int64: the token in each slot, token 0
  in the slots no claim fills; the last column is the trash a dropped
  claim's token goes to (0 where none was dropped);
* ``counts [G, E]`` int64: all claims on each expert, before capacity.

It is registered as the custom op ``repro_torch::moe_route_slots`` (with a
fake implementation), so capture sees one graph node.  Inside the op the
device decides (:func:`route_slots_path`):

* a CUDA tensor launches the hand-written kernel (``csrc/moe_route.cu``;
  it replaces no TPU kernel: XLA runs the JAX package's count) or raises —
  there is no fallback;
* any other tensor (a CPU one) takes :func:`route_slots_plain`, the one-hot count that
  ``models/moe.py::route`` ran before the kernel, which the CPU tests hold
  to the reference.

Both give the same integers; only the trash column may hold another of the
dropped tokens (the kernel's: the first dropped claim's), and nothing reads
it.
"""
# no `from __future__ import annotations`: torch.library infers the op
# schema from real annotation objects
import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_EXPERTS", "MAX_ROUNDS", "THREADS", "WARPS", "route_grid", "route_slots",
           "route_slots_cuda", "route_slots_path", "route_slots_plain"]

THREADS = 256        # a tile's CTA (kThreads in csrc/moe_route.cu)
WARPS = THREADS // 32
MAX_ROUNDS = 16      # 32-claim rounds a warp (kMaxRounds)
MAX_EXPERTS = 1024   # the router widths the kernel takes (kMaxExperts)
_count_lock = threading.Lock()


def route_slots_plain(expert_idx: torch.Tensor, n_experts: int,
                      capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """One cumulative count over the claims laid out rank-major: an int64
    one-hot ``[G, k*Tg, E]`` summed along the claims; the outputs in the
    kernel's layout (contiguous ``[G, Tg, k]``)."""
    G, Tg, top_k = expert_idx.shape
    E = n_experts
    dev = expert_idx.device
    claims = expert_idx.transpose(1, 2).reshape(G, top_k * Tg)  # rank-major
    onehot = (claims[..., None] == torch.arange(E, device=dev)).to(torch.int64)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)  # [G, k*Tg]
    keep = pos < capacity
    pos = torch.where(keep, pos, capacity)
    g_iota = torch.arange(G, device=dev)[:, None].expand(G, top_k * Tg)
    tok = torch.arange(Tg, device=dev).repeat(top_k)[None].expand(G, top_k * Tg)
    # duplicate indices occur only in the trash column, which no one reads
    slot_tok = torch.zeros((G, E, capacity + 1), dtype=torch.int64, device=dev)
    slot_tok = slot_tok.index_put((g_iota, claims, pos), tok)
    counts = onehot.sum(1)                                      # claims per expert
    return (pos.reshape(G, top_k, Tg).transpose(1, 2).contiguous(),
            keep.reshape(G, top_k, Tg).transpose(1, 2).contiguous(), slot_tok, counts)


def route_grid(n_claims: int) -> tuple[int, int]:
    """``(rounds, tiles)`` of a group of ``n_claims`` claims: each warp takes
    ``rounds`` rounds of 32 claims, a tile (one CTA) ``THREADS * rounds``;
    rounds grow with the claims, so that a group has at most 32 tiles up to
    ``32 * THREADS * MAX_ROUNDS`` claims."""
    rounds = min(MAX_ROUNDS, max(1, -(-n_claims // (32 * THREADS))))
    return rounds, max(1, -(-n_claims // (THREADS * rounds)))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("moe_route")
    fn = lib.moe_route_slots
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(expert_idx: torch.Tensor, n_experts: int, capacity: int) -> None:
    if expert_idx.dim() != 3:
        raise ValueError(f"moe_route_slots: expert_idx must be [G, Tg, k], got "
                         f"{tuple(expert_idx.shape)}")
    if expert_idx.dtype != torch.int64:
        raise TypeError(f"moe_route_slots: expert_idx must be int64, got {expert_idx.dtype}")
    if n_experts < 1 or capacity < 0:
        raise ValueError(f"moe_route_slots: {n_experts} experts, capacity {capacity}")


def route_slots_path(expert_idx: torch.Tensor) -> str:
    """The path a call takes, the op's one rule: ``"kernel"`` on a CUDA
    tensor, ``"plain"`` otherwise (a CPU tensor; fake and meta tensors take
    the fake implementation and run neither)."""
    return "kernel" if expert_idx.is_cuda else "plain"


def route_slots_cuda(expert_idx: torch.Tensor, n_experts: int,
                     capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Launch the kernel's two passes on the current stream (the executor's).

    ``expert_idx [G, Tg, k]`` int64 on one card; any E up to MAX_EXPERTS.
    Raises on anything the kernel does not take and on a refused launch.
    Counts one in ``route_slots_cuda.launches`` per call."""
    if not expert_idx.is_cuda:
        raise ValueError(f"moe_route_slots_cuda: needs a CUDA tensor, expert_idx is on "
                         f"{expert_idx.device}")
    _check(expert_idx, n_experts, capacity)
    if n_experts > MAX_EXPERTS:
        raise ValueError(f"moe_route_slots_cuda: {n_experts} experts, the kernel takes at most "
                         f"{MAX_EXPERTS}")
    G, Tg, k = expert_idx.shape
    if G > 65535 or k * Tg > 2**31 - 1 - THREADS * MAX_ROUNDS:
        raise ValueError(f"moe_route_slots_cuda: {G} groups of {k} x {Tg} claims is beyond the "
                         "kernel's grid")
    idx = expert_idx.contiguous()
    dev = idx.device
    positions = torch.empty((G, Tg, k), dtype=torch.int64, device=dev)
    keep = torch.empty((G, Tg, k), dtype=torch.bool, device=dev)
    slot_tok = torch.empty((G, n_experts, capacity + 1), dtype=torch.int64, device=dev)
    counts = torch.empty((G, n_experts), dtype=torch.int64, device=dev)
    if idx.numel() == 0:                       # no claim: empty slots, no count
        return positions, keep, slot_tok.zero_(), counts.zero_()
    rounds, tiles = route_grid(k * Tg)
    scratch = torch.empty(G * tiles * (WARPS + 1) * n_experts, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().moe_route_slots(idx.data_ptr(), positions.data_ptr(), keep.data_ptr(),
                                 slot_tok.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                                 G, Tg, k, n_experts, capacity, rounds, stream)
    if err != 0:
        raise RuntimeError(f"moe_route_slots kernel launch failed: CUDA error {err}")
    with _count_lock:
        route_slots_cuda.launches += 1
    return positions, keep, slot_tok, counts


route_slots_cuda.launches = 0


@torch.library.custom_op("repro_torch::moe_route_slots", mutates_args=())
def _route_slots_op(expert_idx: torch.Tensor, n_experts: int,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    if route_slots_path(expert_idx) == "kernel":
        return route_slots_cuda(expert_idx, n_experts, capacity)
    _check(expert_idx, n_experts, capacity)
    return route_slots_plain(expert_idx, n_experts, capacity)


@_route_slots_op.register_fake
def _(expert_idx, n_experts, capacity):
    _check(expert_idx, n_experts, capacity)
    G = expert_idx.shape[0]
    return (expert_idx.new_empty(expert_idx.shape),
            expert_idx.new_empty(expert_idx.shape, dtype=torch.bool),
            expert_idx.new_empty((G, n_experts, capacity + 1)),
            expert_idx.new_empty((G, n_experts)))


def route_slots(expert_idx: torch.Tensor, n_experts: int,
                capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(positions, keep, slot_tok, counts)`` of the claims of ``expert_idx
    [G, Tg, k]`` on ``n_experts`` experts of ``capacity`` slots each (the
    module's docstring)."""
    return torch.ops.repro_torch.moe_route_slots(expert_idx, n_experts, capacity)
