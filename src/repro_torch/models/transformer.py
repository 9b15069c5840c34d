"""Language models over a dense or a block-paged cache: RoPE attention
(dense or MoE FFN), Mamba (falcon-mamba) and Griffin's RG-LRU mixed with
local attention (recurrentgemma).  A ``parallel_block`` arch
(command-r-plus) runs attention and the FFN side by side on one normed
input, ``x + attn(h) + ffn(h)``: the two branches of a layer share no path
until the residual sum, which is what lets a captured graph's scheduler
put them on two streams.  Two frontend stubs take precomputed embeddings
(the reference's): llava's ``batch["image_embeds"]`` go ahead of the
token embeddings at prefill and in the training forward; whisper's
``batch["frames"]`` run through an encoder (sinusoidal positions,
non-causal attention blocks) whose output every decoder layer
cross-attends to, after its self-attention: in the training forward, at
prefill and, kept as ``cache["enc"]``, at every decode step (sinusoidal
positions, no rope).

A latent-attention arch (moonlight-16b-a3b, the DeepSeek-V3 block: MLA,
leading dense layers, MoE layers with sigmoid routing, shared experts and
a card's share of the routed experts) has no counterpart in the JAX
package; it trains through the same forward and refuses every serving
entry point (:func:`serving_supported`).  The training lookup of the
embedding sums each row's gradient in f32 and rounds once
(:func:`embedding_grad`).

The serving subset of the JAX package's ``models/transformer.py`` and its
training forward, as plain functions on tensors:

    init_params(cfg, seed, device=)                     -> params
    params_from_jax(cfg, np_params, device=)            -> params
    forward(cfg, params, batch, remat=)                 -> (logits [B,S,Vp] f32, aux)

    # dense cache: linear / ring buffers with position tables
    init_cache(cfg, batch, max_len, per_slot=, device=) -> cache
    prefill(cfg, params, batch, cache)                  -> (logits [B,Vp], cache)
        # batch: tokens [B,S] (+ image_embeds [B,n_img,D] | frames [B,encoder_len,D])
    decode_step(cfg, params, tokens [B,1], cache)       -> (logits [B,Vp], cache)
    cache_insert_slot(cfg, cache, sub, slot)            -> cache
    cache_evict_slot(cfg, cache, slot)                  -> cache
    cache_from_jax(cfg, np_cache, device=) / cache_to_stacked(cache)

    # paged cache: global page pool + per-request page tables
    init_paged_cache(cfg, batch, max_len, n_pages=, page_size=, device=)
    paged_decode_step(cfg, params, tokens [B,1], cache) -> (logits [B,Vp], cache)
    paged_prefill_chunk(cfg, params, tokens [1,T], pages, table_row, start, valid_len)
                                                       -> (logits [1,Vp], k_chunk, v_chunk)
    paged_insert_chunk(cfg, pages, table_row, start, valid_len, k_chunk, v_chunk)
    paged_copy_page(cfg, pages, src, dst)

Layout: ``params["layers"]``, ``cache["layers"]`` and ``pages`` are
per-layer lists (the JAX package stacks them ``[L, ...]`` for
``lax.scan``; a Python loop over layers is PyTorch's idiom).
``params_from_jax``, ``cache_from_jax`` / ``cache_to_stacked`` and
``pages_from_jax`` / ``pages_to_stacked`` convert between the two.
Whisper's encoder layers are ``params["enc_layers"]``, a list the same
way.

*Dense cache.*  Each attention layer holds ``{"k": [B, C, Hkv, hd], "v": ...,
"pos": [C] | [B, C]}`` with ``C = min(max_len, sliding_window)``: entry ``s``
holds the token at absolute position ``pos[s]`` (-1 = empty), so linear
caches and the ring buffers of windowed archs share one layout.  The wave
engine's cache has one position table and a scalar ``len``; the per-slot
layout (``per_slot=True``, the continuous-batching engine) has ``pos [B,
C]`` and ``len [B]``, every row a request at its own position.  Prefill
attention is ``layers.chunked_attention`` (kernel B3 on a CUDA tensor),
decode attention ``layers.decode_attention`` (kernel B2, both forms);
whisper's encoder and cross-attention, prefill and decode alike, are
non-causal ``layers.chunked_attention`` (B3).  A
MoE arch's FFN is ``moe.moe_ffn`` (kernel B5 under the expert products).
A recurrent layer holds its state instead, ``{"h": [B, ...] f32, "conv":
[B, K-1, width]}``: a Mamba layer (``kind == "ssm"``, no FFN) runs kernel
B6 under its selective scan, an RG-LRU layer (``"rglru"``, with the FFN)
kernel B7 under its recurrence, in prefill and in decode alike.  A pad
token would enter the recurrent state, so those archs prefill at the exact
prompt length (``valid_len`` is refused) and have no paged cache.

*Paged cache.*  Each layer's pool is ``{"k": [P, ps, Hkv, hd], "v": ...}``;
``table [B, n_pt]`` int32 maps each slot's logical page to a physical page
(-1 = unmapped) and ``len [B]`` is the slot's length.  The logical KV
position of table entry ``(j, t)`` is ``j*ps + t``.  Writes go only to rows
whose target page is mapped — idle rows and padded chunk positions are
selected out before the ``index_put``, never redirected into a wrapped or
clamped page.

Caches and pools are updated **out of place**, as the reference's
functional updates are: each step returns new tensors.  The step functions
are traceable by ``make_fx``: no ``.item()``, no Python branch on tensor
values.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.dist.sharding import is_dtensor, mesh_context, shard
from repro_torch.kernels.decode_attention import paged_decode_attention

from .griffin import (init_rglru_cache, init_rglru_params, rglru_block, rglru_decode_step,
                      rglru_prefill)
from .layers import (apply_rope, chunked_attention, decode_attention, glu_ffn, masked_attention,
                     rms_norm, sinusoidal_at, sinusoidal_positions)
from .mamba import (init_mamba_cache, init_mamba_params, mamba_block, mamba_decode_step,
                    mamba_prefill)
from .moe import init_moe_params, moe_ffn

__all__ = [
    "init_params",
    "params_from_jax",
    "forward",
    "check_trainable",
    "init_cache",
    "prefill",
    "decode_step",
    "cache_insert_slot",
    "cache_evict_slot",
    "cache_from_jax",
    "cache_to_stacked",
    "pages_from_jax",
    "pages_to_stacked",
    "paged_supported",
    "serving_supported",
    "init_paged_cache",
    "alloc_page",
    "free_pages",
    "paged_decode_step",
    "paged_prefill_chunk",
    "paged_insert_chunk",
    "paged_copy_page",
]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

_KINDS = ("attn", "ssm", "rglru")


def _check_arch(cfg: ModelConfig) -> None:
    """What this package serves: language models whose layers are attention
    (dense or MoE FFN, sequential or parallel blocks), Mamba or RG-LRU
    blocks, and the reference's two frontend stubs: ``"vision"`` (image
    embeddings ahead of the text) and ``"audio"`` (an encoder, and
    cross-attention in every decoder layer, which must then be sequential
    attention blocks).  (:func:`paged_supported` is the narrower set the
    paged cache takes.)"""
    kinds = set(cfg.layer_kinds())
    audio = cfg.frontend == "audio"
    if (not kinds <= set(_KINDS) or cfg.frontend not in (None, "audio", "vision")
            or audio != bool(cfg.n_encoder_layers and cfg.cross_attention)
            or (audio and (kinds != {"attn"} or cfg.parallel_block))):
        raise ValueError(
            "this package serves archs of attention (dense or MoE), Mamba and RG-LRU "
            "layers, and the audio (encoder + cross-attention) and vision frontends "
            f"(got {cfg.name}: kinds={kinds}, frontend={cfg.frontend!r}, encoder layers "
            f"{cfg.n_encoder_layers}, cross_attention={cfg.cross_attention})")


def serving_supported(cfg: ModelConfig) -> bool:
    """Whether the serving entry points (caches, prefill, decode, the paged
    functions) take ``cfg``: every arch :func:`_check_arch` takes but one
    with latent attention (MLA), which trains only."""
    return not cfg.mla


def _check_serving(cfg: ModelConfig) -> None:
    _check_arch(cfg)
    if not serving_supported(cfg):
        raise ValueError(f"{cfg.name}: latent attention (MLA) trains only; serving it needs a "
                         "latent cache, which is not ported")


def init_params(cfg: ModelConfig, seed: int | torch.Generator = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` on ``device`` (a CUDA device must exist unless the
    caller asks for the CPU).  The numbers differ from the JAX package's
    for the same seed; parity tests convert its weights with
    :func:`params_from_jax` instead."""
    from repro_torch.device import resolve_device

    _check_arch(cfg)
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    dtype = cfg.dtype

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale
        return w.to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    params: dict[str, Any] = {
        "embed": normal((cfg.padded_vocab, d), d ** -0.5),
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.padded_vocab), d ** -0.5)

    def attn():
        if cfg.mla:
            H, r, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
            hv = H * cfg.v_head_dim
            return {
                "wq": normal((d, H * cfg.qk_head_dim), d ** -0.5),
                "wkv_a": normal((d, r + rope), d ** -0.5),
                "ln_kv": zeros(r),
                "wkv_b": normal((r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), r ** -0.5),
                "wo": normal((hv, d), hv ** -0.5),
            }
        return {
            "wq": normal((d, cfg.n_heads * hd), d ** -0.5),
            "wk": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
            "wv": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
            "wo": normal((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
        }

    def mlp(i: int) -> dict:
        if cfg.is_moe_layer(i):
            return init_moe_params(d, f, cfg.n_experts, dtype, generator=gen, device=dev,
                                   router_width=cfg.router_width,
                                   n_shared=cfg.n_shared_experts,
                                   router_bias=cfg.router_scoring == "sigmoid")
        fd = cfg.dense_d_ff or f
        return {
            "w_gate": normal((d, fd), d ** -0.5),
            "w_up": normal((d, fd), d ** -0.5),
            "w_down": normal((fd, d), fd ** -0.5),
        }

    def layer(i: int, kind: str, cross: bool) -> dict:
        if kind == "ssm":          # a Mamba layer has no FFN
            return {"ln1": zeros(d),
                    "ssm": init_mamba_params(cfg, dtype, generator=gen, device=dev)}
        lp: dict[str, Any] = {"ln1": zeros(d)}
        if kind == "rglru":
            lp["rnn"] = init_rglru_params(cfg, dtype, generator=gen, device=dev)
        else:
            lp["attn"] = attn()
        if cross:                  # whisper's decoder: cross-attention to the encoder
            lp["ln_x"] = zeros(d)
            lp["xattn"] = attn()
        lp["ln2"] = zeros(d)
        lp["mlp"] = mlp(i)
        return lp

    params["layers"] = [layer(i, kind, cfg.cross_attention)
                        for i, kind in enumerate(cfg.layer_kinds())]
    if cfg.n_encoder_layers:
        params["enc_layers"] = [layer(0, "attn", False) for _ in range(cfg.n_encoder_layers)]
        params["enc_norm"] = zeros(d)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, order="C")      # a C-ordered copy; keeps 0-dim shapes
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in from_numpy: move
        # the raw bits and reinterpret them
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _unstack(tree, n: int) -> list:
    return [_tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def params_from_jax(cfg: ModelConfig, np_params, *, device: str | torch.device = "cuda") -> dict:
    """The JAX package's ``init_params`` pytree (leaves as numpy arrays,
    bf16 as ``ml_dtypes.bfloat16``) as this package's params: the same
    values, each leaf in its own dtype (a MoE router, Mamba's ``A_log``,
    ``D`` and ``dt_bias`` and RG-LRU's ``lam`` stay f32 inside a bf16
    model), stacked ``[L, ...]`` layer leaves split into the per-layer
    list (whisper's ``enc_layers``, always stacked there, too)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n_stacked = {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers}
    out = {}
    for k, v in np_params.items():
        if k not in n_stacked:
            out[k] = _tree_map(lambda a: _to_torch(a, dev), v)
            continue
        if isinstance(v, dict):            # scan_layers: stacked leaves
            v = _unstack(v, n_stacked[k])
        out[k] = [_tree_map(lambda a: _to_torch(a, dev), lp) for lp in v]
    return out


def pages_from_jax(cfg: ModelConfig, np_pages, *, device: str | torch.device = "cuda") -> list:
    """The reference's paged pools (stacked ``{"k": [L,P,ps,Hkv,hd], ...}``
    or a per-layer list) as this package's per-layer list."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if isinstance(np_pages, dict):
        np_pages = _unstack(np_pages, cfg.n_layers)
    return [_tree_map(lambda a: _to_torch(a, dev), pg) for pg in np_pages]


def _np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def pages_to_stacked(pages: list) -> dict:
    """The inverse of :func:`pages_from_jax`: per-layer pools stacked to the
    reference's ``{"k": [L, P, ps, Hkv, hd], "v": ...}`` numpy layout (bf16
    comes back as float32, which holds every bf16 value exactly)."""
    return {kk: np.stack([_np_of(pg[kk]) for pg in pages]) for kk in ("k", "v")}


# ---------------------------------------------------------------------------
# embedding / logits / blocks
# ---------------------------------------------------------------------------

def embedding_grad(ids: torch.Tensor, grad: torch.Tensor, n_rows: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The gradient of ``table[ids]`` for a table of ``n_rows`` rows in
    ``dtype``: each row's occurrences summed in f32, in token order, and
    rounded once.  (PyTorch's own backward of the lookup, ``index_put_``
    with ``accumulate`` on the bf16 table, rounds the row after every
    occurrence, so a frequent token's row comes out short.)  No ``[n_rows,
    D]`` f32 table and no sync: the occurrences, sorted by id (stably),
    are summed per run of one id into ``[T, D]`` f32 rows; each run's row
    is then stored at its id, the rows past the last run repeating the
    last run (equal values to one place, so the store is exact)."""
    D = grad.shape[-1]
    flat = ids.reshape(-1)
    T = flat.numel()
    dev = grad.device
    out = torch.zeros((n_rows, D), dtype=dtype, device=dev)
    if T == 0:
        return out
    # no write into a view: a captured graph's executors order its nodes by
    # their data, and such a write is no node's input; the table is filled in
    # place (its one reader is the op's result), the small tensors out of place
    sorted_ids, order = torch.sort(flat, stable=True)
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_ids[1:] != sorted_ids[:-1]])
    run = torch.cumsum(starts, 0) - 1                           # run of each sorted position
    rows = grad.reshape(T, D)[order].float()
    sums = torch.zeros((T, D), dtype=torch.float32, device=dev).index_put(
        (run,), rows, accumulate=True)
    run_id = torch.zeros(T, dtype=flat.dtype, device=dev).index_put((run,), sorted_ids)
    take = torch.minimum(torch.arange(T, device=dev), run[-1])
    return out.index_put_((run_id[take],), sums[take].to(dtype))


class _EmbedRows(torch.autograd.Function):
    """``table[ids]`` whose gradient is :func:`embedding_grad`'s."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return embedding_grad(ids, grad, ctx.rows, grad.dtype), None


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           pos_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings; an arch without rope (whisper) adds its sinusoidal
    positions: the table over the S tokens, or at decode the single
    position ``pos_offset`` (a scalar, shared, or ``[B]``, per slot)."""
    embed = params["embed"]
    if is_dtensor(embed):
        from repro_torch.dist import kernel_rules

        x = kernel_rules.embedding(embed, tokens)     # vocab-parallel lookup
    elif embed.requires_grad and torch.is_grad_enabled():
        x = _EmbedRows.apply(embed, tokens.long())
    else:
        x = embed[tokens.long()]
    if cfg.tie_embeddings:  # gemma-family normalizes the tied embedding
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    if cfg.rope_theta <= 0:
        if pos_offset is None:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, device=x.device)[None]
        else:
            pe = sinusoidal_at(pos_offset, cfg.d_model, x.dtype)
            x = x + (pe[None, None] if pe.dim() == 1 else pe[:, None])
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    if is_dtensor(x):
        from repro_torch.dist import kernel_rules

        x = kernel_rules.gather_seq(x)
    return torch.matmul(x, w).float()


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.sliding_window if (kind == "attn" and cfg.sliding_window) else None


def _mlp_train(cfg: ModelConfig, mp, x: torch.Tensor):
    """The block's FFN and its MoE load-balancing loss: ``(out, aux)``,
    ``aux`` 0.0 for a dense FFN (the reference's ``_mlp_apply``) and for
    sigmoid routing.  A layer is MoE where its params hold a router (a
    MoE arch's leading dense layers hold none)."""
    if "router" in mp:
        return moe_ffn(mp, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       act=cfg.act, scoring=cfg.router_scoring, scaling=cfg.routed_scaling)
    return glu_ffn(x, mp["w_gate"], mp["w_up"], mp["w_down"], cfg.act), 0.0


def _block_tail(cfg: ModelConfig, lp, x: torch.Tensor, h: torch.Tensor, mix: torch.Tensor, *,
                enc: torch.Tensor | None = None, positions: torch.Tensor | None = None):
    """A block's residual sums and FFN after its mixer's output ``mix``:
    ``(x, aux)``.  A parallel block (command-r) feeds the FFN the mixer's
    own normed input ``h`` and sums ``x + mix + ffn(h)`` (its ``ln2`` is
    kept in the params and unused, as the reference's is); a sequential
    block adds ``mix`` first, then, given the encoder output ``enc``
    (whisper's decoder), ``xattn(rms_norm(x, ln_x))`` over it (queries at
    ``positions``), and feeds the FFN ``rms_norm(x, ln2)``.
    A serving caller drops ``aux``, as every serving call site of the
    reference drops a MoE FFN's load-balancing loss."""
    if cfg.parallel_block:
        mlp_out, aux = _mlp_train(cfg, lp["mlp"], h)
        return x + mix + mlp_out, aux
    x = x + mix
    if enc is not None:
        hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        xo, _ = _attn_apply(cfg, lp["xattn"], hx, positions=positions, causal=False, window=None,
                            kv_override=enc)
        x = x + xo
    mlp_out, aux = _mlp_train(cfg, lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x + mlp_out, aux


def _qkv(cfg: ModelConfig, ap, h: torch.Tensor, src: torch.Tensor | None = None):
    """q from ``h``, k and v from ``src`` (``h`` itself unless given)."""
    src = h if src is None else src
    if is_dtensor(h):
        from repro_torch.dist import kernel_rules

        h, src = kernel_rules.gather_seq(h), kernel_rules.gather_seq(src)
    hd = cfg.resolved_head_dim
    q = _split_heads(torch.matmul(h, ap["wq"]), cfg.n_heads, hd)
    k = _split_heads(torch.matmul(src, ap["wk"]), cfg.n_kv_heads, hd)
    v = _split_heads(torch.matmul(src, ap["wv"]), cfg.n_kv_heads, hd)
    return q, k, v


def _split_heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """``[B, S, n_heads * hd]`` -> ``[B, S, n_heads, hd]``.  On a mesh, a
    projection whose columns are split over more ranks than there are
    heads is gathered first (whole heads only; ``shard()`` then places
    them)."""
    if is_dtensor(t):
        from repro_torch.dist import kernel_rules

        t = kernel_rules.whole_units(t, n_heads)
    return t.reshape(t.shape[0], t.shape[1], n_heads, hd)


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def check_trainable(cfg: ModelConfig) -> None:
    """What this package trains: every arch :func:`_check_arch` takes,
    latent attention (which it does not serve) among them:
    attention with a dense or MoE FFN in sequential or parallel blocks,
    Mamba and RG-LRU layers, and the two frontend stubs, llava's image
    rows ahead of the text and whisper's encoder with cross-attention in
    every decoder layer.  Their gradients run the backward kernels of B3
    (attention: causal, windowed, and non-causal with Sq != Skv for the
    encoder and the cross-attention), B5 (expert products), B6 (selective
    scan) and B7 (RG-LRU recurrence).  What ``_check_arch`` refuses stays
    refused: an audio frontend without an encoder, an encoder without the
    audio frontend, and audio with parallel blocks (the reference's
    parallel branch would drop the encoder output) or with layers other
    than attention."""
    _check_arch(cfg)


def unread_params(cfg: ModelConfig) -> frozenset[str]:
    """The leaves of ``init_params(cfg)`` that no gradient reaches, as key
    paths (``pytree.keystr``): a parallel block's ``ln2``, kept as the
    reference keeps it, and a sigmoid router's correction bias, which
    enters only the choice of experts.  Their gradient is zero, as
    ``jax.grad`` gives it (``train.step.value_and_grad``'s ``unread``)."""
    if cfg.router_scoring == "sigmoid":       # the bias enters the choice alone
        return frozenset(f"['layers'][{i}]['mlp']['router_bias']" for i in range(cfg.n_layers)
                         if cfg.is_moe_layer(i))
    if not cfg.parallel_block:
        return frozenset()
    return frozenset(f"['layers'][{i}]['ln2']" for i in range(cfg.n_layers))


def _block_train(cfg: ModelConfig, lp, kind: str, x: torch.Tensor,
                 enc: torch.Tensor | None = None, *, positions: torch.Tensor,
                 window: int | None, causal: bool = True):
    """One residual block over the full sequence: ``(x, aux)`` — the
    reference's ``_block_train``.  A Mamba layer has no FFN and no aux; an
    attention or RG-LRU layer adds its FFN's (a MoE load-balancing loss,
    else 0.0).  ``causal=False`` is whisper's encoder; given the encoder
    output ``enc``, a whisper decoder layer cross-attends to it after its
    self-attention, its queries at ``positions`` (``_block_tail``)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        return x + mamba_block(lp["ssm"], h), 0.0
    if kind == "attn" and cfg.mla:
        mix = _mla_apply(cfg, lp["attn"], h, positions)
    elif kind == "attn":
        mix, _ = _attn_apply(cfg, lp["attn"], h, positions=positions, causal=causal,
                             window=window)
    else:  # rglru
        mix = rglru_block(lp["rnn"], h)
    return _block_tail(cfg, lp, x, h, mix, enc=enc, positions=positions)


def _mla_apply(cfg: ModelConfig, ap, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Latent attention (MLA, DeepSeek-V2/V3) over the full sequence, causal:
    q from ``h`` (``[nope | rope]`` a head); the latent ``[c_kv | k_pe]``
    from ``h``; ``c_kv`` RMS-normed (``1 + w``) and projected up to each
    head's ``k_nope`` and ``v``; rope on ``q_pe`` and on the one ``k_pe``
    every head shares; k = ``[k_nope | k_pe]``; softmax scale
    ``(nope + rope)^-0.5``; ``wo`` from the heads' ``v_head_dim`` outputs.
    Kernel B3 takes q / k of width ``nope + rope`` and v of width
    ``v_head_dim`` (and B3-bwd its gradient).

    With the recorder on it is the spans ``mla.project`` (q, the latent,
    its norm and up-projection, rope) and ``mla.attend`` (B3 and ``wo``),
    again in remat's recompute (marked ``recompute``), and their backward
    ``mla.attend.bwd`` and ``mla.project.bwd``."""
    if is_dtensor(h):
        raise NotImplementedError(f"{cfg.name}: latent attention runs on one device only")
    B, S, _ = h.shape
    H, nope, rope, dv = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    r = cfg.kv_lora_rank
    rec = trace.live(h)
    attrs = {"recompute": True} if rec and torch._C._current_graph_task_id() != -1 else {}
    hooks = rec and not attrs and h.requires_grad and torch.is_grad_enabled()
    hp = h.view_as(h) if hooks else h
    with trace.span("mla.project", **attrs):
        q = torch.matmul(hp, ap["wq"]).reshape(B, S, H, nope + rope)
        latent = torch.matmul(hp, ap["wkv_a"])                    # [B, S, r + rope]
        c_kv = rms_norm(latent[..., :r], ap["ln_kv"], cfg.norm_eps)
        kv = torch.matmul(c_kv, ap["wkv_b"]).reshape(B, S, H, nope + dv)
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)],
                      dim=-1)
        k_pe = apply_rope(latent[..., None, r:], positions, cfg.rope_theta)   # [B, S, 1, rope]
        k = torch.cat([kv[..., :nope], k_pe.expand(B, S, H, rope)], dim=-1)
        v = kv[..., nope:]
    with trace.span("mla.attend", **attrs):
        out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                q_chunk=cfg.attn_q_chunk)
        proj = torch.matmul(out.reshape(B, S, H * dv), ap["wo"])
    if hooks:
        trace.backward_spans([proj, q, hp], ["mla.attend.bwd", "mla.project.bwd"])
    return proj


def _recompute_span(layer: int):
    """``checkpoint``'s contexts: none around the forward, the span
    ``model.recompute`` around the layer's recompute in the backward."""
    return contextlib.nullcontext(), trace.span("model.recompute", layer=layer)


def forward(cfg: ModelConfig, params, batch: dict, *, remat: bool = False):
    """Training forward. batch: tokens [B, S] (+ image_embeds [B, n_img, D]
    | frames [B, encoder_len, D]).  Returns (logits [B, S_total,
    padded_vocab] f32, aux loss: a 0-dim f32, the sum over the layers of
    each MoE FFN's load-balancing loss in layer order — zero for an arch
    without experts — as the reference's).

    Frontends, as the reference's: a vision arch's ``image_embeds``, when
    the batch has them, are cast to the embedding's dtype and go ahead of
    the token embeddings (positions and logits then run over all
    ``n_img + S`` rows; ``models.api.lm_loss`` scores the text's tail); an
    audio arch runs ``batch["frames"]`` (in their own dtype) through the
    encoder, whose output every decoder layer cross-attends to.

    Attention is ``layers.chunked_attention``, which takes the training op
    (kernel B3 and its backward kernel) while autograd records; the expert
    products (B5), the selective scan (B6) and the RG-LRU recurrence (B7)
    are custom ops whose registered gradients are their backward kernels.
    ``remat`` recomputes each decoder layer in the backward pass
    (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint`` per layer): only the residual stream
    between layers (and the encoder output) is kept, and each decoder
    layer's forward runs twice a step (the recomputed MoE routing is the
    same integer ops on the same inputs, so it claims the same slots).
    The encoder is not recomputed, as the reference's ``lax.scan`` over
    it has no ``jax.checkpoint``.  With the recorder on
    (:mod:`repro_torch.core.trace`) each layer's recompute is the span
    ``model.recompute``."""
    from functools import partial

    from torch.utils.checkpoint import checkpoint

    check_trainable(cfg)
    x = _embed(cfg, params, batch["tokens"])
    enc = None
    if cfg.frontend == "vision" and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    if cfg.frontend == "audio":
        if "frames" not in batch:
            raise ValueError(f"{cfg.name}: a training batch needs the encoder's input "
                             "batch['frames'] [B, encoder_len, d_model]")
        enc = _encode(cfg, params, batch["frames"])
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # residual stream: batch over the data axes, sequence over the model
    # axis when the cell shards activations (Megatron-SP)
    x = shard(x, "batch", "seq", None)
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        blk = partial(_block_train, cfg, lp, kind, positions=positions,
                      window=_window_for(cfg, kind))
        if remat:
            spans = {"context_fn": partial(_recompute_span, i)} if trace.live(x) else {}
            x, a = checkpoint(blk, x, enc, use_reentrant=False, **spans)
        else:
            x, a = blk(x, enc)
        x = shard(x, "batch", "seq", None)
        if isinstance(a, torch.Tensor):      # a MoE FFN's; 0.0 adds nothing
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# dense KV cache: linear / ring buffers with position tables
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    w = cfg.sliding_window
    return min(max_len, w) if w else max_len


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, per_slot: bool,
                 device: torch.device) -> dict:
    if kind == "ssm":
        return init_mamba_cache(cfg, batch, cfg.dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, cfg.dtype, device)
    C = _attn_cache_len(cfg, max_len)
    shape = (batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.full((batch, C) if per_slot else (C,), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, per_slot: bool = False,
               device: str | torch.device = "cuda") -> dict:
    """KV / state cache for ``batch`` sequences of up to ``max_len`` tokens
    on ``device`` (a CUDA device must exist unless the caller asks for the
    CPU).

    ``per_slot=True`` is the continuous-batching layout: every batch row is
    an independent request *slot* with its own decode position (``len`` is
    ``[batch]``, attention position tables are ``[batch, C]``), so rows at
    different depths decode in one step and free slots are re-filled via
    :func:`cache_insert_slot` / :func:`cache_evict_slot`.  Recurrent layers
    hold one state row per slot in either layout.  An audio arch's cache
    also holds the encoder output ``enc`` ``[batch, encoder_len, d_model]``,
    which :func:`prefill` writes and decode reads.
    """
    from repro_torch.device import resolve_device

    _check_serving(cfg)
    dev = resolve_device(device)
    layers = [_layer_cache(cfg, kind, batch, max_len, per_slot, dev)
              for kind in cfg.layer_kinds()]
    shape = (batch,) if per_slot else ()
    cache = {"len": torch.zeros(shape, dtype=torch.int32, device=dev), "layers": layers}
    if cfg.frontend == "audio":
        cache["enc"] = torch.zeros((batch, cfg.encoder_len, cfg.d_model), dtype=cfg.dtype,
                                   device=dev)
    return cache


def cache_from_jax(cfg: ModelConfig, np_cache, *, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_cache`` pytree (stacked ``{"k": [L, B, C, Hkv,
    hd], "v", "pos"}`` or ``{"h", "conv"}`` layers, or a per-layer list;
    leaves as numpy) as this package's cache, each leaf in its own dtype
    (a recurrent ``h`` stays f32 in a bf16 model); an ``enc`` leaf too."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    layers = np_cache["layers"]
    if isinstance(layers, dict):
        layers = _unstack(layers, cfg.n_layers)
    cache = {"len": _to_torch(np_cache["len"], dev),
             "layers": [_tree_map(lambda a: _to_torch(a, dev), lc) for lc in layers]}
    if "enc" in np_cache:
        cache["enc"] = _to_torch(np_cache["enc"], dev)
    return cache


def cache_to_stacked(cache: dict) -> dict:
    """The inverse of :func:`cache_from_jax`: the per-layer cache in the
    reference's numpy layout — every leaf stacked ``[L, ...]`` when all
    layers are of one kind (the reference's scanned layout), else a
    per-layer list of dicts (its layout for a mixed pattern).  bf16 comes
    back as float32, which holds every bf16 value exactly."""
    layers = cache["layers"]
    keys = set(layers[0])
    if all(set(lc) == keys for lc in layers):
        out = {kk: np.stack([_np_of(lc[kk]) for lc in layers]) for kk in layers[0]}
    else:
        out = [{kk: _np_of(t) for kk, t in lc.items()} for lc in layers]
    stacked = {"len": _np_of(cache["len"]), "layers": out}
    if "enc" in cache:
        stacked["enc"] = _np_of(cache["enc"])
    return stacked


def _write_prefill(lc: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write full-sequence K/V [B, S, ...] into a (possibly ring) cache: the
    last ``min(S, C)`` positions land at ``pos % C``."""
    C = lc["k"].shape[1]
    S = k.shape[1]
    take = min(S, C)
    pos = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slots = (pos % C).long()
    tbl = lc["pos"]
    if tbl.dim() == 2:   # per-slot table: broadcast over the batch rows
        new_pos = tbl.index_copy(1, slots, pos.expand(tbl.shape[0], take).contiguous())
    else:
        new_pos = tbl.index_copy(0, slots, pos)
    return {"k": lc["k"].index_copy(1, slots, k[:, -take:]),
            "v": lc["v"].index_copy(1, slots, v[:, -take:]),
            "pos": new_pos}


def _slot_index(slot, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(slot, device=device).reshape(1).long()


def cache_insert_slot(cfg: ModelConfig, cache: dict, sub: dict, slot) -> dict:
    """Install a single-request cache (``init_cache(cfg, 1, ..., per_slot=True)``
    filled by :func:`prefill`) into row ``slot`` of a shared per-slot cache.

    Overwrites the slot's K/V, position table and recurrent state (``h``
    in f32, ``conv`` in the model dtype) wholesale, so whatever the previous
    occupant (or an idle slot's garbage decode steps, which advance its
    state) left behind is evicted by construction.  Returns a new cache
    (out of place: every layer's leaves are copied)."""
    del cfg
    idx = _slot_index(slot, cache["len"].device)
    layers = [{kk: dst[kk].index_copy(0, idx, src[kk][:1]) for kk in dst}
              for dst, src in zip(cache["layers"], sub["layers"])]
    length = cache["len"].index_copy(0, idx, sub["len"][:1].to(cache["len"].dtype))
    return {**cache, "layers": layers, "len": length}


def cache_evict_slot(cfg: ModelConfig, cache: dict, slot) -> dict:
    """Free row ``slot``: its attention position tables go to -1 (attention
    masks every entry out) and its length resets.  K/V and recurrent state
    stay in place — unreachable once the positions are cleared (a state
    layer has none and gains none), overwritten by the next
    :func:`cache_insert_slot`."""
    del cfg
    idx = _slot_index(slot, cache["len"].device)
    layers = [{**lc, "pos": lc["pos"].index_fill(0, idx, -1)} if "pos" in lc else lc
              for lc in cache["layers"]]
    return {**cache, "layers": layers, "len": cache["len"].index_fill(0, idx, 0)}


def _attn_apply(cfg: ModelConfig, ap, x: torch.Tensor, *, positions: torch.Tensor | None,
                causal: bool, window: int | None, kv_override: torch.Tensor | None = None):
    """Full-sequence attention.  Returns (projected output, (k, v)) with
    k after rope, as the cache stores it.  ``kv_override`` (cross-attention:
    the encoder output, the first item of the reference's ``(k_src, None)``)
    is what k and v are projected from, k without rope.

    On a mesh, the reference's policy: heads over the model axis when they
    divide it (Megatron); otherwise the independent q rows over it (the
    MQA / few-head case, ``"attn_seq"``: each rank's rows start at its own
    offset, which B3 takes as ``q_offset``), k / v gathered.  The
    row-parallel epilogue lands sequence-sharded."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, ap, x, kv_override)
    ctx = mesh_context()
    tp = ctx.extent(ctx.resolve("model")) if ctx else 1
    if tp > 1 and cfg.n_heads % tp == 0:
        spec = ("batch", None, "model", None)
        q, k, v = shard(q, *spec), shard(k, *spec), shard(v, *spec)
        out_spec = spec
    else:
        q = shard(q, "batch", "attn_seq", None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
        out_spec = ("batch", "attn_seq", None, None)
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_override is None:
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            chunk=cfg.attn_chunk, q_chunk=cfg.attn_q_chunk)
    out = shard(out, *out_spec)
    wo = ap["wo"]
    if is_dtensor(out):
        from repro_torch.dist import kernel_rules

        # the q-row case: rows back together, and the projection's rows
        # whole heads on every rank (its gradient flows back through the
        # same head split)
        out = kernel_rules.gather_seq(out)
        wo = kernel_rules.whole_units(wo, cfg.n_heads, dim=0)
    proj = torch.matmul(out.reshape(B, S, -1), wo)
    return shard(proj, "batch", "seq", None), (k, v)


def _block_decode(cfg: ModelConfig, lp, kind: str, x: torch.Tensor, lc: dict, *,
                  q_pos: torch.Tensor, enc: torch.Tensor | None = None):
    """Single-token block step over a dense cache.  x: [B, 1, D]; q_pos: []
    (shared position) or [B] (per-slot); ``enc``: the encoder output a
    whisper decoder layer cross-attends to, its K / V projected anew at
    every step, as the reference does.  Returns (x, new layer cache)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, lc = mamba_decode_step(lp["ssm"], h, lc)
        return x + out, lc
    if kind == "rglru":
        mix, lc = rglru_decode_step(lp["rnn"], h, lc)
        return _block_tail(cfg, lp, x, h, mix)[0], lc
    ap = lp["attn"]
    B = x.shape[0]
    q, k, v = _qkv(cfg, ap, h)
    pos_arr = q_pos[:, None] if q_pos.dim() else q_pos[None]
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    C = lc["k"].shape[1]
    if is_dtensor(lc["k"]):
        # a cache sequence-sharded over the mesh: each rank writes its range
        from repro_torch.dist import kernel_rules

        lc = kernel_rules.cache_write(lc, k, v, q_pos)
    elif q_pos.dim():
        # continuous batching: each row writes at its own ring slot (idle
        # rows too: their slot is overwritten wholesale at the next insert)
        slots = (q_pos % C).long()
        rows = torch.arange(B, device=x.device)
        lc = {"k": lc["k"].index_put((rows, slots), k[:, 0]),
              "v": lc["v"].index_put((rows, slots), v[:, 0]),
              "pos": lc["pos"].index_put((rows, slots), q_pos)}
    else:
        slot = (q_pos % C).reshape(1).long()
        lc = {"k": lc["k"].index_copy(1, slot, k),
              "v": lc["v"].index_copy(1, slot, v),
              "pos": lc["pos"].index_copy(0, slot, q_pos.reshape(1))}
    out = decode_attention(q, lc["k"], lc["v"], lc["pos"], q_pos,
                           window=_window_for(cfg, kind))
    mix = torch.matmul(out.reshape(B, 1, -1), ap["wo"])
    return _block_tail(cfg, lp, x, h, mix, enc=enc, positions=pos_arr)[0], lc


def _encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings ``[B, T, D]`` (the
    reference's stub frontend): the sinusoidal table added, then the
    non-causal attention blocks and ``enc_norm``.  Prefill and the
    training forward share it (B3's training op while autograd records)."""
    T = frames.shape[1]
    x = frames + sinusoidal_positions(T, cfg.d_model, frames.dtype, device=frames.device)[None]
    pos = torch.arange(T, device=frames.device)
    for lp in params["enc_layers"]:
        x = _block_train(cfg, lp, "attn", x, positions=pos, window=None, causal=False)[0]
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def prefill(cfg: ModelConfig, params, batch: dict, cache: dict):
    """Run the full prompt, fill the cache, return last-position logits.

    ``batch["valid_len"]`` (optional 0-dim int32 tensor) marks the prompt as
    right-padded: only the first ``valid_len`` tokens are real.  Logits come
    from position ``valid_len - 1``, the cache length is ``valid_len``, and
    position-table entries past it are cleared to -1 so later decode steps
    mask the padded K/V out.  This is what lets the serving engines bucket
    prompt lengths to a handful of captured shapes (attention-only archs:
    recurrent state would absorb the pad tokens, so the others refuse it,
    as the reference does).  A recurrent layer runs from a zero state and
    leaves its final state (``h``, and the conv's last K-1 inputs) in the
    cache; the incoming layer cache is not read.

    Frontends: a vision arch's ``batch["image_embeds"]`` ``[B, n_img, D]``
    go ahead of the token embeddings, positions run over all ``n_img + S``
    rows and the cache length is ``n_img + S``; an audio arch encodes
    ``batch["frames"]`` ``[B, encoder_len, D]`` into ``cache["enc"]``, which
    every decoder layer cross-attends to.
    """
    _check_serving(cfg)
    tokens = batch["tokens"]
    valid_len = batch.get("valid_len")
    kinds = cfg.layer_kinds()
    if valid_len is not None and any(k != "attn" for k in kinds):
        raise ValueError("valid_len-masked prefill requires attention-only archs")
    x = _embed(cfg, params, tokens)
    enc = None
    if cfg.frontend == "vision" and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    if cfg.frontend == "audio":
        enc = _encode(cfg, params, batch["frames"])
    S = x.shape[1]
    dev = x.device
    positions = torch.arange(S, device=dev)
    x = shard(x, "batch", "seq", None)
    new_layers = []
    for lp, lc, kind in zip(params["layers"], cache["layers"], kinds):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind == "ssm":          # no FFN in a Mamba layer
            out, lc = mamba_prefill(lp["ssm"], h)
            new_layers.append(lc)
            x = x + out
            continue
        if kind == "rglru":
            mix, lc = rglru_prefill(lp["rnn"], h)
        else:
            mix, (k, v) = _attn_apply(cfg, lp["attn"], h, positions=positions, causal=True,
                                      window=_window_for(cfg, kind))
            lc = _write_prefill(lc, k, v)
        new_layers.append(lc)
        x = shard(_block_tail(cfg, lp, x, h, mix, enc=enc, positions=positions)[0],
                  "batch", "seq", None)

    cache = dict(cache)
    if enc is not None:
        cache["enc"] = enc
    if valid_len is None:
        cache["len"] = torch.full_like(cache["len"], S)
        x_last = x[:, -1]
    else:
        valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
        new_layers = [{**lc, "pos": torch.where(lc["pos"] < valid_len, lc["pos"], -1)}
                      for lc in new_layers]
        cache["len"] = valid_len.expand(cache["len"].shape).clone()
        last = (valid_len - 1).clamp(min=0, max=S - 1).reshape(1).long()
        x_last = x.index_select(1, last)[:, 0]
    cache["layers"] = new_layers
    x = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params, tokens, cache: dict):
    """One decode step over the dense cache.  tokens: [B, 1].
    Returns (logits [B, Vp], new cache with len+1).  A whisper decoder
    cross-attends to ``cache["enc"]``, which passes through unchanged."""
    _check_serving(cfg)
    q_pos = cache["len"].to(torch.int32)
    x = _embed(cfg, params, tokens, pos_offset=q_pos)
    x = shard(x, "batch", None, None)
    enc = cache.get("enc")
    new_layers = []
    for lp, lc, kind in zip(params["layers"], cache["layers"], cfg.layer_kinds()):
        x, lc = _block_decode(cfg, lp, kind, x, lc, q_pos=q_pos, enc=enc)
        new_layers.append(lc)
    cache = dict(cache)
    cache["layers"] = new_layers
    cache["len"] = q_pos + 1
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# paged KV cache: global page pool + per-request page tables
# ---------------------------------------------------------------------------

def paged_supported(cfg: ModelConfig) -> bool:
    """Paged serving covers decoder-only, attention-only, rope archs: SSM /
    RG-LRU carry recurrent state that has no paged analogue, and frontend
    archs (llava, whisper) are not served continuously, as in the
    reference."""
    return (not cfg.frontend and not cfg.n_encoder_layers and serving_supported(cfg)
            and cfg.rope_theta > 0
            and all(k == "attn" for k in cfg.layer_kinds()))


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *, n_pages: int,
                     page_size: int, device: str | torch.device = "cuda") -> dict:
    """Paged KV cache for ``batch`` request slots over a ``n_pages``-page
    global pool.  ``table``/``len`` come back as numpy (host-managed by the
    allocator); ``pages`` are tensors on ``device`` threaded through decode."""
    from repro_torch.device import resolve_device

    _check_serving(cfg)
    if not paged_supported(cfg):
        raise ValueError("paged KV cache requires a decoder-only "
                         "attention-only rope arch "
                         f"(got kinds={cfg.layer_kinds()}, frontend={cfg.frontend!r})")
    dev = resolve_device(device)
    n_pt = -(-max_len // page_size)
    hd = cfg.resolved_head_dim
    shape = (n_pages, page_size, cfg.n_kv_heads, hd)
    pages = [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
              "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
             for _ in range(cfg.n_layers)]
    return {
        "len": np.zeros((batch,), np.int32),
        "table": np.full((batch, n_pt), -1, np.int32),
        "pages": pages,
    }


def alloc_page(cache: dict, slot: int, logical_idx: int, page: int) -> dict:
    """Map physical ``page`` at logical index ``logical_idx`` of ``slot``'s
    page table (host-side bookkeeping; the pool allocator picks ``page``)."""
    table = np.asarray(cache["table"]).copy()
    if table[slot, logical_idx] >= 0:
        raise ValueError(f"slot {slot} logical page {logical_idx} already "
                         f"mapped to {table[slot, logical_idx]}")
    table[slot, logical_idx] = page
    return {**cache, "table": table}


def free_pages(cache: dict, slot: int) -> tuple[dict, list[int]]:
    """Unmap every page of ``slot`` and reset its length.  Returns the new
    cache and the freed physical page ids."""
    table = np.asarray(cache["table"]).copy()
    freed = [int(p) for p in table[slot] if p >= 0]
    table[slot] = -1
    length = np.asarray(cache["len"]).copy()
    length[slot] = 0
    return {**cache, "table": table, "len": length}, freed


def _decode_writes(table: torch.Tensor, q_pos: torch.Tensor, page_size: int):
    """Where each row writes this token's K/V: ``(rows, page, offset)`` of
    the rows whose target page ``table[b, q_pos // ps]`` is mapped.  Rows
    without one (idle slots) are selected out, so they write nothing.  The
    same for every layer, so the one data-dependent size is made once."""
    n_pt = table.shape[1]
    lp = q_pos // page_size
    phys = table.gather(1, lp.clamp(min=0, max=n_pt - 1)[:, None].long())[:, 0]
    keep = (lp < n_pt) & (phys >= 0)
    rows = torch.nonzero(keep)[:, 0]
    return (rows, phys.index_select(0, rows).long(),
            (q_pos % page_size).index_select(0, rows).long())


def _paged_block_decode(cfg: ModelConfig, lp, x, pk, pv, table, q_pos, *, page_size: int,
                        writes=None):
    """Single-token block step over the page pool.  x: [B,1,D];
    pk/pv: [P, ps, Hkv, hd]; table: [B, n_pt]; q_pos: [B]."""
    ap = lp["attn"]
    B = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, ap, h)
    pos_arr = q_pos[:, None]
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    rows, page, off = writes if writes is not None else _decode_writes(table, q_pos, page_size)
    pk = pk.index_put((page, off), k[:, 0].index_select(0, rows))
    pv = pv.index_put((page, off), v[:, 0].index_select(0, rows))
    out = paged_decode_attention(q, pk, pv, table, q_pos, window=_window_for(cfg, "attn"))
    mix = torch.matmul(out.reshape(B, 1, -1), ap["wo"])
    return _block_tail(cfg, lp, x, h, mix)[0], pk, pv


def paged_decode_step(cfg: ModelConfig, params, tokens, cache: dict, *, page_size: int):
    """One decode step over the paged cache.  tokens: [B, 1].
    Returns (logits [B, Vp], new cache with new pools and len+1)."""
    _check_serving(cfg)
    q_pos = cache["len"].to(torch.int32)
    table = cache["table"].to(torch.int32)
    x = _embed(cfg, params, tokens)
    writes = _decode_writes(table, q_pos, page_size)
    new_pages = []
    for lp, pg in zip(params["layers"], cache["pages"]):
        x, pk, pv = _paged_block_decode(cfg, lp, x, pg["k"], pg["v"], table, q_pos,
                                        page_size=page_size, writes=writes)
        new_pages.append({"k": pk, "v": pv})
    cache = dict(cache)
    cache["pages"] = new_pages
    cache["len"] = q_pos + 1
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache


def paged_prefill_chunk(cfg: ModelConfig, params, tokens, pages, table_row, start, valid_len,
                        *, page_size: int):
    """One page-aligned prompt chunk for a single request (chunked prefill).

    tokens: [1, T] (right-padded; first ``valid_len`` real), table_row:
    [n_pt], ``start``: the absolute position of tokens[0] (0-dim int32
    tensors for ``start`` and ``valid_len``).  Reads context K/V at
    positions < start from the pools, computes the chunk's K/V and returns
    it **without writing** (the engine inserts it with
    :func:`paged_insert_chunk`), so this graph can run beside the decode
    step's pool writes.

    Returns (logits [1, Vp] at position start+valid_len-1, k_chunk, v_chunk
    — per-layer lists of [T, Hkv, hd]).
    """
    _check_serving(cfg)
    T = tokens.shape[1]
    dev = tokens.device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
    table_row = table_row.to(torch.int32)
    pos = start + torch.arange(T, dtype=torch.int32, device=dev)     # [T]
    x = _embed(cfg, params, tokens)                                 # rope: positionless
    window = _window_for(cfg, "attn")
    n_pt = table_row.shape[0]
    ps = page_size
    gather = table_row.clamp(min=0).long()
    idx = torch.arange(n_pt * ps, dtype=torch.int32, device=dev)
    mapped = (table_row >= 0).repeat_interleave(ps)
    ctx_pos = torch.where(mapped & (idx < start), idx, -1)
    kv_pos = torch.cat([ctx_pos, pos])
    k_chunk, v_chunk = [], []
    for lp, pg in zip(params["layers"], pages):
        ap = lp["attn"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, ap, h)
        q = apply_rope(q, pos[None], cfg.rope_theta)
        k = apply_rope(k, pos[None], cfg.rope_theta)
        pk, pv = pg["k"], pg["v"]
        ctx_k = pk[gather].reshape(1, n_pt * ps, *pk.shape[2:])
        ctx_v = pv[gather].reshape(1, n_pt * ps, *pv.shape[2:])
        k_all = torch.cat([ctx_k, k], dim=1)
        v_all = torch.cat([ctx_v, v], dim=1)
        out = masked_attention(q, k_all, v_all, kv_pos, pos, window=window)
        mix = torch.matmul(out.reshape(1, T, -1), ap["wo"])
        x = _block_tail(cfg, lp, x, h, mix)[0]
        k_chunk.append(k[0])
        v_chunk.append(v[0])
    last = (valid_len - 1).clamp(min=0, max=T - 1).reshape(1).long()
    x_last = x.index_select(1, last)[:, 0]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x_last), k_chunk, v_chunk


def paged_insert_chunk(cfg: ModelConfig, pages, table_row, start, valid_len, k_chunk, v_chunk,
                       *, page_size: int) -> list:
    """Write a prefill chunk's K/V into the pools through the page table.
    Padded positions (>= valid_len) and unmapped pages are selected out
    and write nothing.  Returns new pools."""
    del cfg
    dev = k_chunk[0].device
    table_row = torch.as_tensor(table_row, dtype=torch.int32, device=dev)
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev)
    T = k_chunk[0].shape[0]
    n_pt = table_row.shape[0]
    ps = page_size
    t = torch.arange(T, dtype=torch.int32, device=dev)
    idx = start + t
    lp = idx // ps
    phys = table_row[lp.clamp(max=n_pt - 1).long()]
    keep = (t < valid_len) & (lp < n_pt) & (phys >= 0)
    rows = torch.nonzero(keep)[:, 0]
    page = phys.index_select(0, rows).long()
    off = (idx % ps).index_select(0, rows).long()
    return [{"k": pg["k"].index_put((page, off), kc.index_select(0, rows)),
             "v": pg["v"].index_put((page, off), vc.index_select(0, rows))}
            for pg, kc, vc in zip(pages, k_chunk, v_chunk)]


def paged_copy_page(cfg: ModelConfig, pages, src: int, dst: int) -> list:
    """Copy physical page ``src`` onto ``dst`` in every layer's pools
    (copy-on-write for a prompt that shares only part of a registered
    page).  Returns new pools."""
    del cfg

    def copy(a: torch.Tensor) -> torch.Tensor:
        b = a.clone()
        b[dst] = a[src]
        return b

    return [{"k": copy(pg["k"]), "v": copy(pg["v"])} for pg in pages]
