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
    n_experts: int = 0               # experts held here (a chip's share of the router's)
    top_k: int = 0
    capacity_factor: float = 1.25
    n_routed_experts: int = 0        # the router's width; 0 -> n_experts
    n_shared_experts: int = 0        # one GLU of this many times d_ff on every token
    router_scoring: str = "softmax"  # softmax | sigmoid (with a choice-only bias)
    routed_scaling: float = 1.0      # gates times this (sigmoid scoring)
    first_dense_layers: int = 0      # leading layers with a dense FFN in a MoE arch
    dense_d_ff: int = 0              # their FFN width; 0 -> d_ff
    # --- latent attention (MLA; on when kv_lora_rank > 0) ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
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
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def router_width(self) -> int:
        return self.n_routed_experts or self.n_experts

    @property
    def qk_head_dim(self) -> int:
        """Width of an MLA query / key head: ``nope + rope``."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.n_experts) and i >= self.first_dense_layers

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

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.mla:
            H, r = self.n_heads, self.kv_lora_rank
            return (d * H * self.qk_head_dim + d * (r + self.qk_rope_head_dim) + r  # + norm
                    + r * H * (self.qk_nope_head_dim + self.v_head_dim)
                    + H * self.v_head_dim * d)
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

    def _ffn_params(self, i: int) -> int:
        """Layer ``i``'s FFN: a dense GLU, or the held experts, the shared
        experts, the router and, under sigmoid scoring, its bias."""
        d, f = self.d_model, self.d_ff
        glu = 3 if self.act in ("silu", "gelu") else 2
        if not self.is_moe_layer(i):
            return glu * d * (self.dense_d_ff or f)
        router = d * self.router_width + (self.router_width if self.router_scoring == "sigmoid"
                                          else 0)
        return (self.n_experts + self.n_shared_experts) * 3 * d * f + router

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math:
        the experts held here (``n_experts``)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i, kind in enumerate(self.layer_kinds()):
            if kind == "attn":
                total += self._attn_params() + self._ffn_params(i) + 2 * d
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
        """Active (per-token) parameters — MoE counts top_k experts only,
        of them the held share's part (``n_experts`` of the router's
        width), and every shared expert."""
        if not self.n_experts:
            return self.n_params()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        expert = 3 * self.d_model * self.d_ff
        held_moe = self.n_experts * expert
        active_moe = self.top_k * expert * self.n_experts // self.router_width
        return int(self.n_params() - moe_layers * (held_moe - active_moe))

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


# the archs this package serves so far; the JAX package's zoo lists the rest.
# A config is looked up by its module key (dashes for underscores):
# h2o-danube3-4b's CONFIG.name is "h2o-danube-3-4b", which names no module.
_ARCHS = [
    "gemma_2b",
    "olmoe_1b_7b",
    "granite_moe_1b_a400m",
    "falcon_mamba_7b",
    "recurrentgemma_2b",
    "yi_9b",
    "h2o_danube3_4b",
    "command_r_plus_104b",
    "whisper_medium",
    "llava_next_34b",
    "moonlight_16b_a3b",
]


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    key = name.replace("-", "_")
    if key not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ported: {_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG
