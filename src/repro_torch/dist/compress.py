"""Compressed cross-replica gradient reduction with error feedback — the
port of the JAX package's ``dist/compress.py``.

The multi-pod mesh's ``pod`` axis crosses the inter-node network
(``launch/mesh.py``), where gradient all-reduces are bandwidth-bound;
8-bit quantization cuts the wire format 4x.  Plain quantized reduction
biases training, so each rank carries its quantization residual forward
(error feedback, Seide et al. / Karimireddy et al.): what this step rounds
away is added back before the next step's quantization, making the
*accumulated* gradient unbiased.

``compressed_psum`` is one rank's body: each rank contributes its local
gradient block, the wire carries int8 codes and one f32 scale per rank
(two ``all_gather`` calls), and every rank reconstructs the mean.
"""
from __future__ import annotations

import torch

__all__ = ["compressed_psum"]


def compressed_psum(
    g: torch.Tensor,
    err: torch.Tensor,
    *,
    group=None,
    bits: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` over the ranks of ``group`` (the default group when
    None) through a ``bits``-wide codebook.

    Returns ``(mean, new_err)``: the dequantized cross-rank mean (same
    shape as the local ``g``) and this rank's new quantization residual,
    to be fed back as ``err`` on the next call."""
    import torch.distributed as dist

    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits}: int8 wire format supports 2..8 bits")
    comp = g.float() + err.float()
    levels = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(comp.abs().max() / levels, min=1e-12)      # one per rank
    q = torch.clamp(torch.round(comp / scale), -levels, levels)
    new_err = comp - q * scale

    # wire format: int8 codes + one f32 scale per rank (the compression)
    n = dist.get_world_size(group)
    codes = [torch.empty(g.numel(), dtype=torch.int8, device=g.device) for _ in range(n)]
    scales = [torch.empty(1, dtype=torch.float32, device=g.device) for _ in range(n)]
    dist.all_gather(codes, q.to(torch.int8).reshape(-1).contiguous(), group=group)
    dist.all_gather(scales, scale.reshape(1), group=group)
    mean = (torch.stack(codes).float() * torch.cat(scales).reshape(n, 1)).sum(0) / n
    return mean.reshape(g.shape), new_err
