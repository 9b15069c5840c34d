"""Decoder-only language models over a dense or a block-paged cache: RoPE
attention (dense or MoE FFN), Mamba (falcon-mamba) and Griffin's RG-LRU
mixed with local attention (recurrentgemma).

The serving subset of the JAX package's ``models/transformer.py`` and its
training forward, as plain functions on tensors:

    init_params(cfg, seed, device=)                     -> params
    params_from_jax(cfg, np_params, device=)            -> params
    forward(cfg, params, batch, remat=)                 -> (logits [B,S,Vp] f32, aux)

    # dense cache: linear / ring buffers with position tables
    init_cache(cfg, batch, max_len, per_slot=, device=) -> cache
    prefill(cfg, params, batch, cache)                  -> (logits [B,Vp], cache)
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

*Dense cache.*  Each attention layer holds ``{"k": [B, C, Hkv, hd], "v": ...,
"pos": [C] | [B, C]}`` with ``C = min(max_len, sliding_window)``: entry ``s``
holds the token at absolute position ``pos[s]`` (-1 = empty), so linear
caches and the ring buffers of windowed archs share one layout.  The wave
engine's cache has one position table and a scalar ``len``; the per-slot
layout (``per_slot=True``, the continuous-batching engine) has ``pos [B,
C]`` and ``len [B]``, every row a request at its own position.  Prefill
attention is ``layers.chunked_attention`` (kernel B3 on a CUDA tensor),
decode attention ``layers.decode_attention`` (kernel B2, both forms).  A
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

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import paged_decode_attention

from .griffin import (init_rglru_cache, init_rglru_params, rglru_block, rglru_decode_step,
                      rglru_prefill)
from .layers import (apply_rope, chunked_attention, decode_attention, glu_ffn, masked_attention,
                     rms_norm)
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
    """What this package serves: decoder-only rope language models whose
    layers are attention (dense or MoE FFN), Mamba or RG-LRU blocks.
    (:func:`paged_supported` is the narrower set the paged cache takes.)"""
    if (cfg.frontend or cfg.n_encoder_layers or cfg.rope_theta <= 0
            or not set(cfg.layer_kinds()) <= set(_KINDS)
            or cfg.parallel_block or cfg.cross_attention):
        raise ValueError(
            "this package serves decoder-only rope archs of attention (dense or MoE), "
            f"Mamba and RG-LRU layers (got {cfg.name}: kinds={set(cfg.layer_kinds())}, "
            f"frontend={cfg.frontend!r}, parallel_block={cfg.parallel_block}, "
            f"cross_attention={cfg.cross_attention})")


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
    layers = []
    for kind in cfg.layer_kinds():
        if kind == "ssm":          # a Mamba layer has no FFN
            layers.append({"ln1": zeros(d),
                           "ssm": init_mamba_params(cfg, dtype, generator=gen, device=dev)})
            continue
        lp: dict[str, Any] = {"ln1": zeros(d)}
        if kind == "rglru":
            lp["rnn"] = init_rglru_params(cfg, dtype, generator=gen, device=dev)
        else:
            lp["attn"] = {
                "wq": normal((d, cfg.n_heads * hd), d ** -0.5),
                "wk": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
                "wv": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
                "wo": normal((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
            }
        lp["ln2"] = zeros(d)
        lp["mlp"] = (init_moe_params(d, f, cfg.n_experts, dtype, generator=gen, device=dev)
                     if cfg.n_experts else {
                         "w_gate": normal((d, f), d ** -0.5),
                         "w_up": normal((d, f), d ** -0.5),
                         "w_down": normal((f, d), f ** -0.5),
                     })
        layers.append(lp)
    params["layers"] = layers
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
    list."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = {k: _tree_map(lambda a: _to_torch(a, dev), v)
           for k, v in np_params.items() if k != "layers"}
    layers = np_params["layers"]
    if isinstance(layers, dict):           # scan_layers: stacked leaves
        layers = _unstack(layers, cfg.n_layers)
    out["layers"] = [_tree_map(lambda a: _to_torch(a, dev), lp) for lp in layers]
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

def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.rope_theta <= 0:
        raise ValueError("absolute-position (sinusoidal) archs are not ported")
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:  # gemma-family normalizes the tied embedding
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    return torch.matmul(x, w).float()


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.sliding_window if (kind == "attn" and cfg.sliding_window) else None


def _mlp_train(cfg: ModelConfig, mp, x: torch.Tensor):
    """The block's FFN and its MoE load-balancing loss: ``(out, aux)``,
    ``aux`` 0.0 for a dense FFN (the reference's ``_mlp_apply``)."""
    if cfg.n_experts:
        return moe_ffn(mp, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       act=cfg.act)
    return glu_ffn(x, mp["w_gate"], mp["w_up"], mp["w_down"], cfg.act), 0.0


def _mlp_apply(cfg: ModelConfig, mp, x: torch.Tensor) -> torch.Tensor:
    """The block's FFN.  A MoE arch's load-balancing loss is dropped here,
    as every serving call site of the reference drops it."""
    return _mlp_train(cfg, mp, x)[0]


def _qkv(cfg: ModelConfig, ap, h: torch.Tensor):
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(h, ap["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = torch.matmul(h, ap["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(h, ap["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def check_trainable(cfg: ModelConfig) -> None:
    """What this package trains: every arch it serves (attention with a
    dense or MoE FFN, Mamba and RG-LRU layers), whose gradients run the
    backward kernels of B3 (attention), B5 (expert products), B6 (selective
    scan) and B7 (RG-LRU recurrence).  Frontend / encoder archs are not
    ported at all (their configs, whisper and llava, wait in ROADMAP A2 /
    A10), nor are parallel blocks (command-r-plus, A2 / A10)."""
    if cfg.frontend or cfg.n_encoder_layers or cfg.cross_attention:
        raise ValueError(
            f"{cfg.name}: frontend / encoder archs (frontend={cfg.frontend!r}, "
            f"encoder layers {cfg.n_encoder_layers}) are not ported (ROADMAP A2 / A10)")
    _check_arch(cfg)


def _block_train(cfg: ModelConfig, lp, kind: str, x: torch.Tensor, *,
                 positions: torch.Tensor, window: int | None):
    """One residual block over the full sequence: ``(x, aux)`` — the
    reference's ``_block_train`` for a layer without cross-attention or a
    parallel block.  A Mamba layer has no FFN and no aux; an attention or
    RG-LRU layer adds its FFN's (a MoE load-balancing loss, else 0.0)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        return x + mamba_block(lp["ssm"], h), 0.0
    if kind == "attn":
        mix, _ = _attn_apply(cfg, lp["attn"], h, positions=positions, causal=True,
                             window=window)
    else:  # rglru
        mix = rglru_block(lp["rnn"], h)
    x = x + mix
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    mlp_out, aux = _mlp_train(cfg, lp["mlp"], h2)
    return x + mlp_out, aux


def forward(cfg: ModelConfig, params, batch: dict, *, remat: bool = False):
    """Training forward. batch: tokens [B, S].  Returns (logits [B, S,
    padded_vocab] f32, aux loss: a 0-dim f32, the sum over the layers of
    each MoE FFN's load-balancing loss in layer order — zero for an arch
    without experts — as the reference's).

    Attention is ``layers.chunked_attention``, which takes the training op
    (kernel B3 and its backward kernel) while autograd records; the expert
    products (B5), the selective scan (B6) and the RG-LRU recurrence (B7)
    are custom ops whose registered gradients are their backward kernels.
    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint`` per layer): only the residual stream
    between layers is kept, and each layer's forward runs twice a step
    (the recomputed MoE routing is the same integer ops on the same
    inputs, so it claims the same slots)."""
    from functools import partial

    from torch.utils.checkpoint import checkpoint

    check_trainable(cfg)
    x = _embed(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(params["layers"], cfg.layer_kinds()):
        blk = partial(_block_train, cfg, lp, kind, positions=positions,
                      window=_window_for(cfg, kind))
        x, a = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
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
    hold one state row per slot in either layout.
    """
    from repro_torch.device import resolve_device

    _check_arch(cfg)
    dev = resolve_device(device)
    layers = [_layer_cache(cfg, kind, batch, max_len, per_slot, dev)
              for kind in cfg.layer_kinds()]
    shape = (batch,) if per_slot else ()
    return {"len": torch.zeros(shape, dtype=torch.int32, device=dev), "layers": layers}


def cache_from_jax(cfg: ModelConfig, np_cache, *, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_cache`` pytree (stacked ``{"k": [L, B, C, Hkv,
    hd], "v", "pos"}`` or ``{"h", "conv"}`` layers, or a per-layer list;
    leaves as numpy) as this package's cache, each leaf in its own dtype
    (a recurrent ``h`` stays f32 in a bf16 model)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    layers = np_cache["layers"]
    if isinstance(layers, dict):
        layers = _unstack(layers, cfg.n_layers)
    return {"len": _to_torch(np_cache["len"], dev),
            "layers": [_tree_map(lambda a: _to_torch(a, dev), lc) for lc in layers]}


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
    return {"len": _np_of(cache["len"]), "layers": out}


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


def _attn_apply(cfg: ModelConfig, ap, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool, window: int | None):
    """Full-sequence attention (no mesh: the reference's sharding
    constraints are no-ops here).  Returns (projected output, (k, v)) with
    k after rope, as the cache stores it."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, ap, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            chunk=cfg.attn_chunk, q_chunk=cfg.attn_q_chunk)
    return torch.matmul(out.reshape(B, S, -1), ap["wo"]), (k, v)


def _block_decode(cfg: ModelConfig, lp, kind: str, x: torch.Tensor, lc: dict, *,
                  q_pos: torch.Tensor):
    """Single-token block step over a dense cache.  x: [B, 1, D]; q_pos: []
    (shared position) or [B] (per-slot).  Returns (x, new layer cache)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, lc = mamba_decode_step(lp["ssm"], h, lc)
        return x + out, lc
    if kind == "rglru":
        mix, lc = rglru_decode_step(lp["rnn"], h, lc)
        x = x + mix
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp_apply(cfg, lp["mlp"], h2), lc
    ap = lp["attn"]
    B = x.shape[0]
    q, k, v = _qkv(cfg, ap, h)
    pos_arr = q_pos[:, None] if q_pos.dim() else q_pos[None]
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    C = lc["k"].shape[1]
    if q_pos.dim():
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
    x = x + torch.matmul(out.reshape(B, 1, -1), ap["wo"])
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp_apply(cfg, lp["mlp"], h2), lc


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
    """
    tokens = batch["tokens"]
    valid_len = batch.get("valid_len")
    kinds = cfg.layer_kinds()
    if valid_len is not None and any(k != "attn" for k in kinds):
        raise ValueError("valid_len-masked prefill requires attention-only archs")
    x = _embed(cfg, params, tokens)
    S = x.shape[1]
    dev = x.device
    positions = torch.arange(S, device=dev)
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
        x = x + mix
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_apply(cfg, lp["mlp"], h2)

    cache = dict(cache)
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
    Returns (logits [B, Vp], new cache with len+1)."""
    q_pos = cache["len"].to(torch.int32)
    x = _embed(cfg, params, tokens)
    new_layers = []
    for lp, lc, kind in zip(params["layers"], cache["layers"], cfg.layer_kinds()):
        x, lc = _block_decode(cfg, lp, kind, x, lc, q_pos=q_pos)
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
    RG-LRU carry recurrent state that has no paged analogue."""
    return (not cfg.frontend and not cfg.n_encoder_layers
            and cfg.rope_theta > 0
            and all(k == "attn" for k in cfg.layer_kinds()))


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *, n_pages: int,
                     page_size: int, device: str | torch.device = "cuda") -> dict:
    """Paged KV cache for ``batch`` request slots over a ``n_pages``-page
    global pool.  ``table``/``len`` come back as numpy (host-managed by the
    allocator); ``pages`` are tensors on ``device`` threaded through decode."""
    from repro_torch.device import resolve_device

    _check_arch(cfg)
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
    x = x + mix
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp_apply(cfg, lp["mlp"], h2), pk, pv


def paged_decode_step(cfg: ModelConfig, params, tokens, cache: dict, *, page_size: int):
    """One decode step over the paged cache.  tokens: [B, 1].
    Returns (logits [B, Vp], new cache with new pools and len+1)."""
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
        x = x + mix
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_apply(cfg, lp["mlp"], h2)
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
