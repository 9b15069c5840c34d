"""Compute/communication-overlapped collective matmuls on
``torch.distributed`` point-to-point ops — the port of the JAX package's
``dist/overlap.py``.

A blocking all-gather before a matmul serializes communication and compute
on the same executor; the ring formulation below decomposes both into
per-rank chunks so each hop (``batch_isend_irecv``) is in flight while the
previous chunk's partial matmul runs (the "collective matmul" of Wang et
al.).  Both functions are numerically exact up to the order of disjoint
blocks: the all-gather ring writes each block once, and the reduce-scatter
ring adds the ranks' partial products in the reference's order.

Each function is one rank's body: every rank of ``group`` (the default
group when None) calls it with its own shards.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_allgather_matmul", "ring_reducescatter_matmul"]


def _ring(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _hop(send: torch.Tensor, to: int, frm: int, group) -> tuple[torch.Tensor, list]:
    """Issue one ring hop: send ``send`` to rank ``to``, receive a tensor of
    its shape from ``frm``; returns (receive buffer, requests)."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _peer(group, to), group),
        dist.P2POp(dist.irecv, recv, _peer(group, frm), group),
    ])
    return recv, reqs


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, *, group=None) -> torch.Tensor:
    """``allgather(x) @ w`` without materializing the gather barrier.

    Per rank: ``x`` holds rows [m, k] of the [n*m, k] global operand, ``w``
    a column block [k, c].  Each of the ``n`` steps multiplies the row chunk
    currently held and forwards it around the ring (to rank ``idx - 1``,
    from ``idx + 1``); the next hop is issued *before* the local matmul so
    the transfer overlaps the compute.  Returns the full-row output
    [n*m, c]."""
    n, idx = _ring(group)
    m = x.shape[0]
    out = torch.zeros((n * m, w.shape[1]), dtype=torch.result_type(x, w), device=x.device)
    cur = x.contiguous()
    for i in range(n):
        nxt, reqs = _hop(cur, (idx - 1) % n, (idx + 1) % n, group) if i + 1 < n else (None, [])
        src = (idx + i) % n                      # whose rows we currently hold
        out[src * m:(src + 1) * m] = (cur @ w).to(out.dtype)
        for r in reqs:
            r.wait()
        cur = nxt
    return out


def ring_reducescatter_matmul(x: torch.Tensor, w: torch.Tensor, *, group=None) -> torch.Tensor:
    """``reducescatter(x @ w)`` with the partial-sum ring fused in.

    Per rank: ``x`` holds a column block [M, k], ``w`` a row block [k, c];
    the full product is the sum over ranks of ``x_j @ w_j``.  The
    accumulator for output-row chunk ``b`` starts at rank ``b+1`` and walks
    the ring forward, each rank adding its own contribution to that chunk
    before passing it on, so chunk ``b`` lands fully reduced on rank ``b``
    after ``n-1`` hops.  The product for the next chunk runs while the hop
    is in flight.  Returns the local output-row chunk [M/n, c]."""
    n, idx = _ring(group)
    if x.shape[0] % n != 0:
        raise ValueError(f"rows {x.shape[0]} not divisible by ring size {n}")
    rows = x.shape[0] // n

    def block(b: int) -> torch.Tensor:
        return x[b * rows:(b + 1) * rows] @ w

    acc = block((idx - 1) % n).contiguous()
    for i in range(1, n):
        recv, reqs = _hop(acc, (idx + 1) % n, (idx - 1) % n, group)
        blk = block((idx - 1 - i) % n)
        for r in reqs:
            r.wait()
        acc = recv + blk
    return acc
