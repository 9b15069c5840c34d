"""How the kernels' custom ops run on DTensors.

DTensor has no sharding strategy for a ``torch.library`` custom op (the
kernels B1–B7 and their backwards), so every call site on a sharded path
goes through one of the functions here.  Each one runs the op under
``local_map`` on the rank's local shards, with the offsets a shard needs to
see its own part of the global problem, and declares how the result (and
each input's gradient) is laid out over the mesh:

* :func:`attention` — B3 (``flash_attention`` / its training op).  Heads
  over ``model`` are a local call on the local heads (a rank whose kv heads
  are replicated takes the few it needs); q rows over ``model`` (the
  reference's ``"attn_seq"``, the MQA case) pass the rank's first row as
  the kernel's ``q_offset``, which a static sharding rule could not give.
  A replicated k / v read by sharded queries gets a partial gradient.
* :func:`moe_ffn` — the MoE FFN with its B5 products: each data shard
  routes its own tokens (one routing group, as the reference's
  ``_infer_groups`` gives), each ``model`` rank runs its own experts, and
  the outputs are partial sums over ``model``.
* :func:`replicated_block` — a recurrent block (Mamba with B6, RG-LRU with
  B7) whole on every ``model`` rank over its data shard: no tensor
  parallelism inside the block, its weights gathered.
* :func:`decode_attention` — B2 over a cache sequence-sharded over
  ``model`` (the reference's ``cache_pspecs``): each rank attends over its
  own entries, returning each row's log-sum-exp with its output, and the
  ranks merge with one max and one weighted-sum all-reduce — no gather of
  the cache.  A rank that keeps no entry of a row weighs 0.
  :func:`cache_write` writes a decode step's k / v into such a cache: the
  rank whose range holds the slot writes it, the others keep theirs.
* :func:`embedding` — a token lookup in a table whose rows (the
  vocabulary) are sharded: each rank looks up the tokens its rows hold and
  the outputs are a partial sum (a plain one, which a partial gradient can
  meet on its way back).
* :func:`vocab_parallel_nll` — cross-entropy over logits whose vocabulary
  is sharded (the unembedding is column-parallel): the log-sum-exp from
  per-rank partial sums and each label's logit from the rank that holds
  it, so no rank ever holds a full row of logits.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["attention", "moe_ffn", "decode_attention", "merge_partials",
           "cache_write", "vocab_parallel_nll", "whole_units", "gather_seq",
           "replicated_block", "embedding"]


def _placement_types():
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Partial, Replicate, Shard


def _local_map(fn: Callable, out_placements, in_placements, in_grad_placements, mesh):
    """``local_map`` that redistributes its inputs.  One output's placements
    go as a list (a tuple means one placement tuple per output)."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def _coord(mesh, dim: int) -> int:
    return int(mesh.get_local_rank(dim))


def _as_dtensor(t: torch.Tensor, like) -> Any:
    """``t`` as a DTensor on ``like``'s mesh, replicated (a plain tensor
    every rank holds the same copy of: positions, tables)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t
    Partial, Replicate, Shard = _placement_types()
    return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def attention(op: Callable, q, k, v, **kw) -> Any:
    """``op(q, k, v, **kw)`` (B3's serving or training op, model layout
    ``[B, S, H, hd]``) on DTensors.  q keeps its placements; k / v follow
    q's batch and head shards where they have them and are replicated over
    every other mesh dim."""
    Partial, Replicate, Shard = _placement_types()
    mesh = q.device_mesh
    qp = tuple(q.placements)
    k = _as_dtensor(k, q)
    v = _as_dtensor(v, q)
    qp = tuple(Replicate() if isinstance(p, Partial) else p for p in qp)
    kp, kgrad = [], []
    row_dim = head_dim = None
    for i, p in enumerate(qp):
        have = k.placements[i]
        if p == Shard(0):
            kp.append(Shard(0))
            kgrad.append(Shard(0))
            continue
        if p == Shard(2) and have == Shard(2):
            kp.append(Shard(2))
            kgrad.append(Shard(2))
            continue
        if p not in (Replicate(), Shard(1), Shard(2)):
            raise NotImplementedError(f"attention: q placement {p} on mesh dim {i}")
        if p == Shard(1):
            row_dim = i
        elif p == Shard(2):
            head_dim = i
        kp.append(Replicate())
        # queries split over this dim read all of k / v: each rank's
        # gradient of them is a partial sum
        kgrad.append(Partial() if p != Replicate() else Replicate())
    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    q_offset = int(kw.pop("q_offset", 0))
    if row_dim is not None:
        q_offset += _coord(mesh, row_dim) * (q.shape[1] // mesh.size(row_dim))
    if head_dim is not None:
        hq_l = Hq // mesh.size(head_dim)
        h0 = _coord(mesh, head_dim) * hq_l
        if hq_l % G and G % hq_l:
            raise NotImplementedError(
                f"attention: {hq_l} local query heads do not hold whole groups of {G}")
        kv0, kv1 = h0 // G, (h0 + hq_l - 1) // G + 1

    def local(ql, kl, vl):
        if head_dim is not None and kl.shape[2] == Hkv and kv1 - kv0 != Hkv:
            kl, vl = kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]
        return op(ql, kl, vl, q_offset=q_offset, **kw)

    fn = _local_map(local, list(qp), (qp, tuple(kp), tuple(kp)),
                    (qp, tuple(kgrad), tuple(kgrad)), mesh)
    return fn(q, k, v)


def moe_ffn(dense_moe: Callable, params: dict, x, *, n_groups: int, **kw):
    """The MoE FFN (``models.moe.moe_ffn``, given as ``dense_moe``) on a
    DTensor ``x [B, S, D]``: ``(out, aux)`` as DTensors.

    Each rank routes its local tokens with ``n_groups`` scaled to what it
    holds (one group when x is sharded over exactly the batch axes), runs
    the experts its ``model`` coordinate owns (when the experts divide the
    axis) and combines only their slots; the output is a partial sum over
    ``model``.  The aux loss is a mean over groups: each rank contributes
    its groups' share as a partial sum over the dims that split them."""
    Partial, Replicate, Shard = _placement_types()
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    E = params["router"].shape[-1]
    xp, wp, xg, rg, wg, outp, auxp = [], [], [], [], [], [], []
    batch_split, expert_split, first = 1, 1, 0
    for i, p in enumerate(x.placements):
        size = mesh.size(i)
        if names[i] == "model" and E % size == 0 and size > 1:
            # this rank's experts; every expert rank routes the same tokens
            expert_split = size
            first = _coord(mesh, i) * (E // size)
            xp.append(Replicate()), wp.append(Shard(0))
            xg.append(Partial()), rg.append(Partial()), wg.append(Shard(0))
            outp.append(Partial()), auxp.append(Partial())
        elif p == Shard(0):
            batch_split *= size
            xp.append(Shard(0)), wp.append(Replicate())
            xg.append(Shard(0)), rg.append(Partial()), wg.append(Partial())
            outp.append(Shard(0)), auxp.append(Partial())
        else:
            xp.append(Replicate()), wp.append(Replicate())
            xg.append(Replicate()), rg.append(Replicate()), wg.append(Replicate())
            outp.append(Replicate()), auxp.append(Replicate())
    local_groups = max(1, n_groups // batch_split)
    keys = sorted(params)
    rep = tuple(Replicate() for _ in xp)

    def local(xl, *leaves):
        pl = dict(zip(keys, leaves))
        out, aux = dense_moe(pl, xl, n_groups=local_groups, first_expert=first, **kw)
        # a mean over groups: this rank's groups' share of it, split again
        # over the expert ranks that each compute the same routing
        return out, aux * (local_groups / n_groups) / expert_split

    in_p = [tuple(xp)] + [rep if k == "router" else tuple(wp) for k in keys]
    in_g = [tuple(xg)] + [tuple(rg) if k == "router" else tuple(wg) for k in keys]
    fn = _local_map(local, (tuple(outp), tuple(auxp)), tuple(in_p), tuple(in_g), mesh)
    return fn(x, *(params[k] for k in keys))


def merge_partials(out: torch.Tensor, lse: torch.Tensor, reduce: Callable) -> torch.Tensor:
    """Merge each rank's attention over its own entries: ``out [B, H, hd]``
    (the rank's softmax-normalised output), ``lse [B, H]`` f32 (its rows'
    log-sum-exp, ``-inf`` where it keeps nothing).  ``reduce(t, op)`` is
    the all-reduce over the ranks (``"max"`` / ``"sum"``).  A row that no
    rank keeps weighs every rank equally: each holds the mean of V over its
    own equal share of the cache, and the mean of those is the mean over
    the whole cache, as the unsharded kernel gives it."""
    m = reduce(lse.clone(), "max")
    idle = torch.isneginf(m)
    w = torch.where(idle, torch.ones_like(lse), torch.exp(lse - torch.where(idle, 0.0, m)))
    num = reduce((w[..., None] * out.float()).contiguous(), "sum")
    den = reduce(w.contiguous(), "sum")
    return (num / den[..., None]).to(out.dtype)


def decode_attention(op_lse: Callable, q, k_cache, v_cache, kv_pos, q_pos, *, window=None):
    """B2 over a cache whose entries (dim 1) are sharded over one mesh dim
    (``model``): ``op_lse(q, k, v, kv_pos, q_pos, window) -> (out, lse)``
    runs on each rank's own entries and :func:`merge_partials` combines
    them over that dim.  ``q [B, Hq, hd]`` is replicated over the sequence
    dim; ``kv_pos`` ([S] or [B, S]) is replicated and sliced to the rank's
    range here."""
    import torch.distributed._functional_collectives as funcol

    Partial, Replicate, Shard = _placement_types()
    mesh = k_cache.device_mesh
    kp = tuple(k_cache.placements)
    seq_dims = [i for i, p in enumerate(kp) if p == Shard(1)]
    if len(seq_dims) != 1:
        raise NotImplementedError(f"decode_attention: cache placements {kp}")
    sd = seq_dims[0]
    n = mesh.size(sd)
    S = k_cache.shape[1]
    s_l = S // n
    s0 = _coord(mesh, sd) * s_l
    group = mesh.get_group(sd)
    qp = tuple(Replicate() if (i == sd or not isinstance(p, Shard)) else p
               for i, p in enumerate(kp))
    q = _as_dtensor(q, k_cache)
    kv_pos = _as_dtensor(kv_pos, k_cache)
    q_pos = _as_dtensor(q_pos, k_cache)
    rep = tuple(Replicate() for _ in kp)
    pos_p = rep if kv_pos.dim() == 1 else tuple(
        Shard(0) if p == Shard(0) else Replicate() for p in kp)
    qpos_p = rep if q_pos.dim() == 0 else tuple(
        Shard(0) if p == Shard(0) else Replicate() for p in kp)

    def reduce(t: torch.Tensor, how: str) -> torch.Tensor:
        if n == 1:
            return t
        return funcol.wait_tensor(funcol.all_reduce(t, how, group))

    def local(ql, kl, vl, pl, qpl):
        pl = pl[..., s0:s0 + s_l].contiguous()
        out, lse = op_lse(ql, kl, vl, pl, qpl, window)
        return merge_partials(out, lse, reduce)

    fn = _local_map(local, list(qp), (qp, kp, kp, pos_p, qpos_p), None, mesh)
    return fn(q, k_cache, v_cache, kv_pos, q_pos)


def cache_write(lc: dict, k_new, v_new, q_pos) -> dict:
    """A decode step's write into a dense layer cache whose entries (dim 1)
    are sharded over one mesh dim: entry ``q_pos % C`` takes ``k_new`` /
    ``v_new`` ``[B, 1, Hkv, hd]`` and its position ``q_pos`` (``[]``,
    shared, or ``[B]``, per row: the row's own entry).  Each rank writes
    the entries its range holds and keeps the rest; the position table is
    replicated and every rank writes it whole."""
    Partial, Replicate, Shard = _placement_types()
    kc = lc["k"]
    mesh = kc.device_mesh
    kp = tuple(kc.placements)
    sd = [i for i, p in enumerate(kp) if p == Shard(1)][0]
    C = kc.shape[1]
    s_l = C // mesh.size(sd)
    s0 = _coord(mesh, sd) * s_l
    rows_p = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    new_p = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    pos = _as_dtensor(lc["pos"], kc)
    qp = _as_dtensor(q_pos, kc)
    pos_p = rows_p if pos.dim() == 2 else tuple(Replicate() for _ in kp)
    qpos_p = rows_p if qp.dim() == 1 else tuple(Replicate() for _ in kp)

    def local(kl, vl, knl, vnl, pl, qpl):
        slot = (qpl % C).long()
        ent = torch.arange(s0, s0 + s_l, device=kl.device)
        if qpl.dim():                                   # per row: [B, s_l]
            hit = (ent[None, :] == slot[:, None])
            pl = torch.where(torch.arange(C, device=pl.device)[None, :] == slot[:, None],
                             qpl[:, None], pl)
        else:
            hit = (ent == slot)[None, :].expand(kl.shape[0], s_l)
            pl = torch.where(torch.arange(C, device=pl.device) == slot, qpl, pl)
        m = hit[:, :, None, None]
        return (torch.where(m, knl.expand_as(kl), kl), torch.where(m, vnl.expand_as(vl), vl),
                pl)

    fn = _local_map(local, (kp, kp, pos_p), (kp, kp, new_p, new_p, pos_p, qpos_p), None, mesh)
    k, v, p = fn(kc, lc["v"], k_new, v_new, pos, qp)
    return {"k": k, "v": v, "pos": p}


def vocab_parallel_nll(logits, labels):
    """``-log_softmax(logits)[label]`` per position for DTensor ``logits
    [..., V]`` sharded over its last dim (and ``labels [...]``, in range):
    ``log(sum(exp(z - m))) + m - z[label]`` with the row max ``m`` and both
    sums reduced over the vocab shards."""
    Partial, Replicate, Shard = _placement_types()
    mesh = logits.device_mesh
    lp = tuple(logits.placements)
    last = logits.dim() - 1
    vd = [i for i, p in enumerate(lp)
          if p in (Shard(last), Shard(-1)) and mesh.size(i) > 1][0]
    v_l = logits.shape[-1] // mesh.size(vd)
    v0 = _coord(mesh, vd) * v_l
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    labels = _as_dtensor(labels, logits)
    lab_p = tuple(Replicate() if i == vd else p for i, p in enumerate(lp))
    out_p = tuple(Partial() if i == vd else p for i, p in enumerate(lp))

    def local(ll, lab):
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < v_l)
        got = torch.gather(ll, -1, torch.clamp(idx, 0, v_l - 1)[..., None])[..., 0]
        return torch.where(mine, got, torch.zeros_like(got))

    fn = _local_map(local, list(out_p), (lp, lab_p), (lp, lab_p), mesh)
    return lse - fn(logits, labels)


def whole_units(t, n_units: int, dim: int = -1):
    """``t`` with dim ``dim`` gathered over every mesh dim that would split
    it into parts of whole units (``n_units`` heads of equal width) no
    longer: the layout a reshape to ``[..., n_units, width]`` (or a product
    with such a tensor) can keep."""
    Partial, Replicate, Shard = _placement_types()
    mesh = t.device_mesh
    d = dim % t.dim()
    want = tuple(Replicate() if p in (Shard(d), Shard(d - t.dim())) and n_units % mesh.size(i)
                 else p for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def gather_seq(x):
    """``x [B, S, ...]`` with its sequence (dim 1) gathered over every mesh
    dim that splits it: what Megatron-SP's all-gather does before a
    column-parallel product (the residual stream is sequence-sharded, the
    products read whole rows)."""
    Partial, Replicate, Shard = _placement_types()
    want = tuple(Replicate() if p == Shard(1) else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def replicated_block(core: Callable, params: dict, x, *state):
    """``core(params, x, *state) -> (out, *new_state)`` (``models.mamba``'s
    or ``models.griffin``'s block core) with every weight gathered and the
    block run whole on each rank over its data shard of ``x [B, L, D]``
    (and of each state tensor, ``None`` passing through).  Outputs keep x's
    batch split and are replicated over every other mesh dim; a weight's
    gradient is a partial sum over the data shards."""
    Partial, Replicate, Shard = _placement_types()
    mesh = x.device_mesh
    xp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in x.placements)
    wp = tuple(Replicate() for _ in xp)
    wg = tuple(Partial() if p == Shard(0) else Replicate() for p in xp)
    keys = sorted(params)
    live = [i for i, t in enumerate(state) if t is not None]
    state = [_as_dtensor(t, x) if t is not None else None for t in state]

    def local(xl, *rest):
        pl = dict(zip(keys, rest[:len(keys)]))
        st = [None] * len(state)
        for i, t in zip(live, rest[len(keys):]):
            st[i] = t
        return core(pl, xl, *st)

    n_out = 1 + len(state)
    in_p = (xp,) + (wp,) * len(keys) + (xp,) * len(live)
    in_g = (xp,) + (wg,) * len(keys) + (xp,) * len(live)
    fn = _local_map(local, tuple(xp for _ in range(n_out)), in_p, in_g, mesh)
    return fn(x, *(params[k] for k in keys), *(state[i] for i in live))


def embedding(table, tokens):
    """``table[tokens]`` for a DTensor ``table [V, D]`` whose rows may be
    split over one mesh dim (the vocab-parallel embedding): each rank looks
    up the tokens in its range and writes zeros for the rest; the output
    ``[..., D]`` is a partial sum over that dim and follows ``tokens``'
    batch split.  The table's other dims are gathered first."""
    Partial, Replicate, Shard = _placement_types()
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, table)
    vd = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    vd = vd[0] if len(vd) == 1 else None
    tab_p = tuple(Shard(0) if i == vd else Replicate() for i in range(mesh.ndim))
    tok_p = tuple(Shard(0) if (p == Shard(0) and i != vd) else Replicate()
                  for i, p in enumerate(tokens.placements))
    out_p = tuple(Partial() if i == vd else tok_p[i] for i in range(mesh.ndim))
    tab_g = tuple(Shard(0) if i == vd else (Partial() if tok_p[i] == Shard(0) else Replicate())
                  for i in range(mesh.ndim))
    v_l = table.shape[0] // (mesh.size(vd) if vd is not None else 1)
    v0 = _coord(mesh, vd) * v_l if vd is not None else 0

    def local(tl, tok):
        idx = tok.long() - v0
        mine = (idx >= 0) & (idx < v_l)
        rows = torch.nn.functional.embedding(torch.clamp(idx, 0, v_l - 1), tl)
        return rows * mine[..., None].to(rows.dtype)

    fn = _local_map(local, list(out_p), (tab_p, tok_p), (tab_g, tok_p), mesh)
    return fn(table, tokens)
