"""Model configuration schema + registry.

Every assigned architecture ships as ``configs/<id>.py`` exposing ``CONFIG``
(the exact published hyper-parameters) and ``SMOKE`` (a reduced same-family
config for CPU tests). ``get_config(name, smoke=...)`` is the lookup.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any

import torch

__all__ = ["ModelConfig", "get_config", "list_archs", "SHAPES", "shape_for"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention ---
    sliding_window: int | None = None
    attn_chunk: int = 1024           # KV tile of the online-softmax attention
    attn_q_chunk: int = 512          # Q tile (peak temp ~ q_chunk x chunk)
    # per-layer block pattern for hybrid archs, cycled: e.g. ("rglru","rglru","attn")
    block_pattern: tuple[str, ...] = ("attn",)
    parallel_block: bool = False     # command-r: attn and FFN in parallel
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0             # 0 -> d_model // 16
    # --- RG-LRU (griffin) ---
    lru_width: int = 0               # 0 -> d_model
    # --- structure ---
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    cross_attention: bool = False    # whisper decoder
    n_encoder_layers: int = 0        # whisper
    encoder_len: int = 1500          # whisper frame positions (stub frontend)
    frontend: str | None = None      # audio | vision (stub: embeds provided)
    n_image_tokens: int = 2880       # llava anyres tile budget (stub)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    scan_layers: bool = True
    dtype: torch.dtype = torch.bfloat16
    # --- bookkeeping ---
    source: str = ""                 # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way axes
        (Megatron-style padding; labels never index the pad region)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> list[str]:
        """Block kind per layer (cycled pattern)."""
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    @property
    def is_homogeneous(self) -> bool:
        return len(set(self.layer_kinds())) == 1

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.layer_kinds():
            if kind == "attn":
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                ffn = 3 * d * f if self.act in ("silu", "gelu") else 2 * d * f
                if self.n_experts:
                    ffn = self.n_experts * 3 * d * f + d * self.n_experts
                total += attn + ffn + 2 * d
            elif kind == "ssm":
                di, st, dr = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + di * self.ssm_conv + di * (dr + 2 * st) + dr * di + di * st + di + di * d + d
            elif kind == "rglru":
                r = self.rnn_width
                total += 2 * d * r + r * self.ssm_conv + 3 * r * r + r * d + d
            else:
                raise ValueError(kind)
        if self.cross_attention:
            total += self.n_encoder_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d + 3 * d * f
            )
        return int(total)

    def active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k experts only."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = self.top_k * 3 * d * f
        return int(self.n_params() - self.n_layers * (dense_moe - active_moe))

    def reduced(self, **overrides: Any) -> "ModelConfig":
        return replace(self, **overrides)


# ---------------------------------------------------------------------------
# Assigned input shapes (LM transformer shapes: seq_len x global_batch).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSpec:
    return SHAPES[name]


# the archs this package serves so far; the JAX package's zoo lists the rest
_ARCHS = [
    "gemma_2b",
    "olmoe_1b_7b",
    "granite_moe_1b_a400m",
    "falcon_mamba_7b",
    "recurrentgemma_2b",
]


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    key = name.replace("-", "_")
    if key not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ported: {_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG
