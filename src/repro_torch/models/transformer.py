"""Decoder-only RoPE transformer over a block-paged KV cache.

The paged-serving subset of the JAX package's ``models/transformer.py``,
as plain functions on tensors:

    init_params(cfg, seed, device=)                     -> params
    params_from_jax(cfg, np_params, device=)            -> params
    init_paged_cache(cfg, batch, max_len, n_pages=, page_size=, device=)
    paged_decode_step(cfg, params, tokens [B,1], cache) -> (logits [B,Vp], cache)
    paged_prefill_chunk(cfg, params, tokens [1,T], pages, table_row, start, valid_len)
                                                       -> (logits [1,Vp], k_chunk, v_chunk)
    paged_insert_chunk(cfg, pages, table_row, start, valid_len, k_chunk, v_chunk)
    paged_copy_page(cfg, pages, src, dst)

Layout: ``params["layers"]`` and ``pages`` are per-layer lists (the JAX
package stacks them ``[L, ...]`` for ``lax.scan``; a Python loop over
layers is PyTorch's idiom).  ``params_from_jax`` and ``pages_from_jax`` /
``pages_to_stacked`` convert between the two.  Each layer's pool is
``{"k": [P, ps, Hkv, hd], "v": ...}``; ``table [B, n_pt]`` int32 maps each
slot's logical page to a physical page (-1 = unmapped) and ``len [B]`` is
the slot's length.  The logical KV position of table entry ``(j, t)`` is
``j*ps + t``.

Pools are updated **out of place**, as the reference's functional updates
are: each decode step returns new pools.  Writes go only to rows whose
target page is mapped — idle rows and padded chunk positions are selected
out before the ``index_put``, never redirected into a wrapped or clamped
page.  The step functions are traceable by ``make_fx``: no ``.item()``, no
Python branch on tensor values.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import paged_decode_attention

from .layers import apply_rope, glu_ffn, masked_attention, rms_norm

__all__ = [
    "init_params",
    "params_from_jax",
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

def _check_arch(cfg: ModelConfig) -> None:
    if not paged_supported(cfg) or cfg.n_experts or cfg.parallel_block or cfg.cross_attention:
        raise ValueError(
            "this package serves decoder-only, attention-only, dense rope archs "
            f"(got {cfg.name}: kinds={set(cfg.layer_kinds())}, experts={cfg.n_experts}, "
            f"parallel_block={cfg.parallel_block})")


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
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": zeros(d),
            "attn": {
                "wq": normal((d, cfg.n_heads * hd), d ** -0.5),
                "wk": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
                "wv": normal((d, cfg.n_kv_heads * hd), d ** -0.5),
                "wo": normal((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
            },
            "ln2": zeros(d),
            "mlp": {
                "w_gate": normal((d, f), d ** -0.5),
                "w_up": normal((d, f), d ** -0.5),
                "w_down": normal((f, d), f ** -0.5),
            },
        })
    params["layers"] = layers
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in from_numpy: move
        # the raw bits and reinterpret them
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _unstack(tree, n: int) -> list:
    return [_tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def params_from_jax(cfg: ModelConfig, np_params, *, device: str | torch.device = "cuda") -> dict:
    """The JAX package's ``init_params`` pytree (leaves as numpy arrays,
    bf16 as ``ml_dtypes.bfloat16``) as this package's params: the same
    values, stacked ``[L, ...]`` layer leaves split into the per-layer
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


def pages_to_stacked(pages: list) -> dict:
    """The inverse of :func:`pages_from_jax`: per-layer pools stacked to the
    reference's ``{"k": [L, P, ps, Hkv, hd], "v": ...}`` numpy layout (bf16
    comes back as float32, which holds every bf16 value exactly)."""
    def np_of(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {kk: np.stack([np_of(pg[kk]) for pg in pages]) for kk in ("k", "v")}


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


def _mlp_apply(cfg: ModelConfig, mp, x: torch.Tensor) -> torch.Tensor:
    return glu_ffn(x, mp["w_gate"], mp["w_up"], mp["w_down"], cfg.act)


def _qkv(cfg: ModelConfig, ap, h: torch.Tensor):
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(h, ap["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = torch.matmul(h, ap["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(h, ap["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


# ---------------------------------------------------------------------------
# paged KV cache: global page pool + per-request page tables
# ---------------------------------------------------------------------------

def paged_supported(cfg: ModelConfig) -> bool:
    """Paged serving covers decoder-only, attention-only, rope archs."""
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
