"""Kernel B5's plain version and the port's ``moe_ffn`` on the CPU against
the JAX package, on the same numpy inputs.

* ``moe_gmm_plain`` and the custom op ``repro_torch::moe_gmm`` (which a CPU
  tensor takes to the plain version) against the Pallas kernel (interpret
  mode, as ``tests/test_kernels.py`` runs it) and its pure-jnp oracle;
* ``moe_ffn``: routing first (expert ids, gates, slot positions and keep
  masks must be *equal*: a flip at the top-k boundary would move a whole
  expert's share), then the expert products and the combine under that
  shared routing, then the output and the aux loss against the JAX
  ``moe_ffn`` itself;
* the capacity arithmetic, swept;
* the slot assignment (``repro_torch::moe_route_slots``): its plain
  version against the reference's rank-by-rank count at the card tests'
  shapes and edge cases, and a model of the CUDA kernel's tiles, warps and
  rounds against the plain version; its fake implementation, its capture
  as one node, and the refusals of its CUDA wrapper;
* capture: each of the three products is one ``gemm`` node priced
  ``2·E·C·D·F``, the slot assignment one node of its own, and replay is
  bit-exact.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32, 3e-2 in
bf16.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import moe_gmm as j_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro.models.moe import moe_ffn as j_moe_ffn
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.capture import capture
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_cuda, moe_gmm_plain
from repro_torch.kernels.moe_route import (MAX_EXPERTS, THREADS, WARPS, route_grid, route_slots,
                                           route_slots_cuda, route_slots_path, route_slots_plain)
from repro_torch.models import moe
from torch_route_cases import SLOT_CASES, SLOT_IDS, assert_trash, slot_ids

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 2e-5, "bf16": 3e-2}


def _both(a: np.ndarray, dt: str):
    """The same array in both frameworks, cast to ``dt`` from the same f32
    bits (both round to nearest even)."""
    return jnp.asarray(a).astype(JAX_DT[dt]), torch.from_numpy(a).to(TORCH_DT[dt])


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _gmm_inputs(E, C, D, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    return x, w


# ---------------------------------------------------------------------------
# kernel B5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", [(4, 64, 128, 96), (8, 32, 64, 64), (2, 128, 32, 128)])
def test_plain_and_op_match_pallas_kernel_and_ref(E, C, D, F, dt):
    x, w = _gmm_inputs(E, C, D, F, seed=E + C)
    (jx, tx), (jw, tw) = _both(x, dt), _both(w, dt)
    kern = j_moe_gmm(jx, jw, block_c=32, block_f=32, block_d=32, interpret=True)
    ref = moe_gmm_ref(jx, jw)
    plain = moe_gmm_plain(tx, tw)
    op = moe_gmm(tx, tw)
    assert plain.dtype == op.dtype == TORCH_DT[dt] and tuple(op.shape) == (E, C, F)
    assert torch.equal(op, plain)            # a CPU tensor takes the plain version
    for want in (kern, ref):
        _close(plain, want, TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", [(3, 37, 200, 72), (1, 1, 5, 3), (2, 7, 33, 9),
                                     (32, 8, 64, 24)])
def test_plain_matches_ref_at_ragged_shapes(E, C, D, F, dt):
    """Shapes no block size tiles (the Pallas kernel refuses them; the CUDA
    kernel masks its edges): against the oracle only."""
    x, w = _gmm_inputs(E, C, D, F, seed=D + F)
    (jx, tx), (jw, tw) = _both(x, dt), _both(w, dt)
    _close(moe_gmm(tx, tw), moe_gmm_ref(jx, jw), TOL[dt])


def test_op_refuses_what_the_kernel_cannot_take():
    x, w = torch.zeros((2, 3, 4)), torch.zeros((2, 5, 6))
    with pytest.raises(ValueError, match=r"\[E, C, D\]"):
        moe_gmm(x, w)
    with pytest.raises(ValueError, match="needs CUDA"):
        moe_gmm_cuda(torch.zeros((2, 3, 4)), torch.zeros((2, 4, 6)))


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

def _reference_capacity(Tg, top_k, cf, E):
    """``repro/models/moe.py:66-68``, as written there."""
    capacity = max(top_k, int(round(Tg * top_k * cf / E)))
    if Tg >= 8:
        capacity = -(-capacity // 8) * 8
    return capacity


@pytest.mark.parametrize("top_k,cf,E", [(8, 1.25, 32), (2, 1.25, 8), (8, 1.25, 64),
                                        (2, 0.5, 8), (1, 2.0, 4)])
def test_capacity_sweep_matches_the_reference_formula(top_k, cf, E):
    for T in range(1, 1101):
        assert moe.capacity_for(T, top_k, cf, E) == _reference_capacity(T, top_k, cf, E), T


def test_capacity_at_the_main_paths_shapes():
    """granite (E = 32, top-8): a decode step of 8 rows, a paged chunk of
    128, slot prefills of 200 and 333 tokens (200 gives 62.5, rounded half
    to even), wave prefills of 4 x 200 and 4 x 333; the smoke config's
    4-row decode (E = 8, top-2: 1.25, below top_k)."""
    got = [moe.capacity_for(T, 8, 1.25, 32) for T in (8, 128, 200, 333, 800, 1332)]
    assert got == [8, 40, 64, 104, 256, 416]
    assert moe.capacity_for(4, 2, 1.25, 8) == 2
    assert round(62.5) == 62 and moe.capacity_for(200, 8, 1.25, 32) == 64


# ---------------------------------------------------------------------------
# the slot assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,Tg,k,E,C,how", SLOT_CASES, ids=SLOT_IDS)
def test_plain_slots_match_the_reference(G, Tg, k, E, C, how):
    idx = slot_ids(G, Tg, k, E, how, seed=Tg + k)
    positions, keep, slot_tok, counts = route_slots(idx, E, C)   # a CPU tensor: plain
    assert route_slots_path(idx) == "plain"
    want = route_slots_plain(idx, E, C)
    # the plain version's trash column takes whichever duplicate its
    # scatter writes last, which may differ from call to call
    for got, ref in zip((positions, keep, slot_tok[..., :C], counts),
                        (want[0], want[1], want[2][..., :C], want[3])):
        assert torch.equal(got, ref)
    j_pos, j_keep, j_slot, j_counts = _jax_slots(jnp.asarray(idx.numpy()), E, C)
    np.testing.assert_array_equal(positions.numpy(), np.stack(j_pos, -1))
    np.testing.assert_array_equal(keep.numpy(), np.stack(j_keep, -1))
    np.testing.assert_array_equal(slot_tok[..., :C].numpy(), np.asarray(j_slot)[..., :C])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert_trash(slot_tok, idx, keep, counts, C)
    assert positions.dtype == slot_tok.dtype == counts.dtype == torch.int64
    assert keep.dtype == torch.bool and positions.is_contiguous() and keep.is_contiguous()
    if how != "distinct" or C * E < k * Tg:
        assert not keep.all()                  # these cases drop claims


def _kernel_model(idx, E, C):
    """``csrc/moe_route.cu``'s two passes in numpy, index for index: tiles of
    ``THREADS * rounds`` claims, warp w of a tile ``32 * rounds`` of them in
    rounds of 32 lanes, a lane's rank its earlier lanes on its expert plus
    the warp's running count; ``route_count``'s per-warp and per-tile rows,
    ``route_assign``'s sums over the earlier tiles and warps, its writes
    and the cells it shares out.  Unwritten cells read -1."""
    G, Tg, k = idx.shape
    n = k * Tg
    rounds, tiles = route_grid(n)
    ids = idx.numpy()
    flat = np.full((G, tiles * THREADS * rounds), -1)
    flat[:, :n] = ids.transpose(0, 2, 1).reshape(G, n)        # claim c = r Tg + t
    flat[(flat < 0) | (flat >= E)] = -1
    warp_rows = np.zeros((G, tiles, WARPS, E), np.int64)
    for g in range(G):
        for tile in range(tiles):
            for w in range(WARPS):
                chunk = flat[g, (tile * WARPS + w) * 32 * rounds:][:32 * rounds]
                warp_rows[g, tile, w] = np.bincount(chunk[chunk >= 0], minlength=E)
    tile_rows = warp_rows.sum(2)
    positions = np.full((G, Tg, k), -1)
    keep = np.zeros((G, Tg, k), bool)
    slot_tok = np.full((G, E, C + 1), -1)
    counts = np.full((G, E), -1)
    for g in range(G):
        total = tile_rows[g].sum(0)
        counts[g] = total
        for tile in range(tiles):
            before = tile_rows[g, :tile].sum(0)
            base = before + np.concatenate([np.zeros((1, E), np.int64),
                                            np.cumsum(warp_rows[g, tile], 0)[:-1]])
            for w in range(WARPS):
                run = base[w].copy()
                chunk = (tile * WARPS + w) * 32 * rounds
                for q in range(rounds):
                    lanes = flat[g, chunk + q * 32:chunk + q * 32 + 32]
                    for lane, e in enumerate(lanes):
                        c = chunk + q * 32 + lane
                        first = run[e] if e >= 0 else 0
                        rank = first + int((lanes[:lane] == e).sum()) if e >= 0 else C
                        if c < n:
                            r, t = divmod(c, Tg)
                            positions[g, t, r] = min(rank, C)
                            keep[g, t, r] = rank < C
                            if e >= 0 and rank <= C:
                                assert slot_tok[g, e, rank] == -1      # written once
                                slot_tok[g, e, rank] = t
                    for e in set(lanes[lanes >= 0].tolist()):
                        run[e] += int((lanes == e).sum())
            cells = E * (C + 1)
            per = -(-cells // tiles)
            for i in range(tile * per, min(cells, (tile + 1) * per)):
                e, j = divmod(i, C + 1)
                if (j >= total[e]) if j < C else (total[e] <= C):
                    assert slot_tok[g, e, j] == -1
                    slot_tok[g, e, j] = 0
    return positions, keep, slot_tok, counts


def _chip_smoke():
    """The repository's chip_smoke.py as a module (its phases run only on a
    card; its helpers run anywhere)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("G,Tg,k,E,C,how", SLOT_CASES, ids=SLOT_IDS)
def test_kernel_model_matches_plain_slots(G, Tg, k, E, C, how):
    """The kernel's tiling writes every output element once and gives the
    plain version's integers (the trash column: its first dropped claim)."""
    idx = slot_ids(G, Tg, k, E, how, seed=Tg + k)
    positions, keep, slot_tok, counts = _kernel_model(idx, E, C)
    want = route_slots_plain(idx, E, C)
    np.testing.assert_array_equal(positions, want[0].numpy())
    np.testing.assert_array_equal(keep, want[1].numpy())
    np.testing.assert_array_equal(slot_tok[..., :C], want[2][..., :C].numpy())
    np.testing.assert_array_equal(counts, want[3].numpy())
    assert (slot_tok >= 0).all()
    assert_trash(torch.from_numpy(slot_tok), idx, torch.from_numpy(keep), want[3], C)
    # chip_smoke holds the card's trash column to this rule
    trash = _chip_smoke().route_trash(torch, idx, torch.from_numpy(keep), want[3], C)
    np.testing.assert_array_equal(slot_tok[..., C], trash.numpy())


def test_route_grid_bounds_tiles_and_covers_the_claims():
    assert route_grid(64) == (1, 1)                 # a decode step: one tile
    assert route_grid(49152) == (6, 32) and route_grid(65536) == (8, 32)
    for n in list(range(1, 5000, 37)) + [8192, 8193, 65535, 131072, 32 * THREADS * 16, 10**7]:
        rounds, tiles = route_grid(n)
        assert 1 <= rounds <= 16 and tiles * THREADS * rounds >= n
        assert (tiles - 1) * THREADS * rounds < n
        if n <= 32 * THREADS * 16:
            assert tiles <= 32


def test_slot_fake_implementation_gives_shapes_and_dtypes():
    with FakeTensorMode() as mode:
        idx = mode.from_tensor(torch.zeros((3, 37, 8), dtype=torch.int64))
        positions, keep, slot_tok, counts = route_slots(idx, 32, 16)
    assert [tuple(t.shape) for t in (positions, keep, slot_tok, counts)] == [
        (3, 37, 8), (3, 37, 8), (3, 32, 17), (3, 32)]
    assert [t.dtype for t in (positions, keep, slot_tok, counts)] == [
        torch.int64, torch.bool, torch.int64, torch.int64]
    assert all(t.is_contiguous() for t in (positions, keep, slot_tok, counts))
    meta = route_slots(torch.zeros((1, 8, 2), dtype=torch.int64, device="meta"), 8, 4)
    assert [tuple(t.shape) for t in meta] == [(1, 8, 2), (1, 8, 2), (1, 8, 5), (1, 8)]
    assert all(t.device.type == "meta" for t in meta)


def test_slot_capture_is_one_node_priced_by_its_bytes():
    G, Tg, k, E, C = 2, 40, 4, 16, 12
    idx = slot_ids(G, Tg, k, E, "skewed", seed=1)
    cap = capture(lambda i: route_slots(i, E, C), idx, name="slots")
    (node,) = [n for n in cap.graph.nodes if n.kind != "input"]
    assert node.kind == "moe_route_slots" and node.meta["ops"].count("moe_route_slots") == 1
    claims = G * Tg * k
    assert node.flops == claims and node.bytes_in == 8 * claims
    assert node.bytes_out == 9 * claims + 8 * G * E * (C + 2)
    for got, want in zip(cap.run(idx), route_slots_plain(idx, E, C)):
        assert torch.equal(got, want)


def test_slot_cuda_wrapper_refuses_what_it_cannot_take():
    """A CPU tensor is refused by the CUDA wrapper (the op sends it to the
    plain version); the checks run before any launch."""
    idx = torch.zeros((1, 8, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        route_slots_cuda(idx, 8, 4)
    with pytest.raises(TypeError, match="int64"):
        route_slots(idx.int(), 8, 4)
    with pytest.raises(ValueError, match=r"\[G, Tg, k\]"):
        route_slots(idx[0], 8, 4)
    assert MAX_EXPERTS >= 256


# ---------------------------------------------------------------------------
# moe_ffn against the reference
# ---------------------------------------------------------------------------

def _jax_slots(expert_idx, E, capacity):
    """The reference's capacity assignment (``repro/models/moe.py:82-101``),
    rank by rank, for any ``expert_idx [G, Tg, k]``: per rank the positions
    and keep masks ``[G, Tg]``, the slot table ``[G, E, capacity + 1]`` and
    the claims per expert ``[G, E]``."""
    G, Tg, top_k = expert_idx.shape
    g_iota = jnp.arange(G, dtype=jnp.int32)[:, None]
    counts = jnp.zeros((G, E), jnp.int32)
    slot_tok = jnp.zeros((G, E, capacity + 1), jnp.int32)
    positions, keeps = [], []
    for r in range(top_k):
        e_r = expert_idx[..., r]
        onehot = jax.nn.one_hot(e_r, E, dtype=jnp.int32)
        pos_in_e = (jnp.cumsum(onehot, axis=1) - 1) * onehot
        pos_r = pos_in_e.sum(-1) + jnp.take_along_axis(counts, e_r, axis=1)
        counts = counts + onehot.sum(1)
        within = pos_r < capacity
        pos_r = jnp.where(within, pos_r, capacity)
        positions.append(pos_r)
        keeps.append(within)
        slot_tok = slot_tok.at[g_iota, e_r, pos_r].set(
            jnp.broadcast_to(jnp.arange(Tg, dtype=jnp.int32)[None], (G, Tg)))
    return positions, keeps, slot_tok, counts


def _jax_parts(params, x, *, top_k, capacity_factor, act, n_groups):
    """``repro/models/moe.py:57-135`` step by step (no mesh: its ``shard``
    calls are no-ops), keeping the routing, the expert outputs and the
    combine apart so the port's parts can be held to each.  The test
    asserts first that these parts give the reference's own output."""
    B, S, D = x.shape
    T = B * S
    E = params["router"].shape[-1]
    G = n_groups
    Tg = T // G
    capacity = _reference_capacity(Tg, top_k, capacity_factor, E)
    xg = x.reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    positions, keeps, slot_tok, _ = _jax_slots(expert_idx, E, capacity)
    src = slot_tok[:, :, :capacity]
    xin = jax.vmap(lambda xr, sr: xr[sr.reshape(-1)])(xg, src).reshape(G, E, capacity, D)
    h = jnp.einsum("gecd,edf->gecf", xin, params["w_gate"])
    h = jax.nn.silu(h) if act == "silu" else jax.nn.gelu(h)
    u = jnp.einsum("gecd,edf->gecf", xin, params["w_up"])
    y = jnp.einsum("gecf,efd->gecd", h * u, params["w_down"])
    out = jnp.zeros((G, Tg, D), jnp.float32)
    flat_y = y.reshape(G, E * capacity, D)
    for r in range(top_k):
        pos_r = jnp.minimum(positions[r], capacity - 1)
        idx = expert_idx[..., r] * capacity + pos_r
        y_r = jax.vmap(lambda yr, ir: yr[ir])(flat_y, idx)
        w = (gate_vals[..., r] * keeps[r]).astype(jnp.float32)
        out = out + w[..., None] * y_r.astype(jnp.float32)
    routing = {"gate_vals": gate_vals, "expert_idx": expert_idx,
               "positions": jnp.stack(positions, -1), "keep": jnp.stack(keeps, -1),
               "slot_tok": slot_tok}
    return routing, y, out.reshape(B, S, D).astype(x.dtype), capacity


def _moe_inputs(B, S, D, F, E, dt, seed, *, loud=1.0):
    rng = np.random.default_rng(seed)
    arrays = {"router": rng.standard_normal((D, E)) * D ** -0.5 * loud,
              "w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
              "w_up": rng.standard_normal((E, D, F)) * D ** -0.5,
              "w_down": rng.standard_normal((E, F, D)) * F ** -0.5}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jp = {k: jnp.asarray(v.astype(np.float32)).astype(jnp.float32 if k == "router"
                                                        else JAX_DT[dt])
          for k, v in arrays.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(torch.float32 if k == "router"
                                                         else TORCH_DT[dt])
          for k, v in arrays.items()}
    jx, tx = _both(x, dt)
    return jp, tp, jx, tx


# (B, S, top_k, capacity_factor, act, n_groups, dt): the smoke configs'
# widths (D = 64, F = 32, E = 8, top-2); a call where claims are dropped
# (capacity factor 0.5), two groups, GeGLU, a decode-shaped call, bf16
MOE_CASES = [
    (2, 9, 2, 1.25, "silu", 1, "f32"),
    (1, 64, 2, 0.5, "silu", 1, "f32"),
    (2, 12, 2, 1.25, "silu", 2, "f32"),
    (3, 5, 2, 1.25, "gelu", 1, "f32"),
    (4, 1, 2, 1.25, "silu", 1, "f32"),
    (1, 16, 3, 1.0, "silu", 1, "bf16"),
]


@pytest.mark.parametrize("B,S,top_k,cf,act,G,dt", MOE_CASES)
def test_moe_ffn_matches_reference_part_by_part(B, S, top_k, cf, act, G, dt):
    D, F, E = 64, 32, 8
    jp, tp, jx, tx = _moe_inputs(B, S, D, F, E, dt, seed=B * 100 + S, loud=4.0)
    kw = dict(top_k=top_k, capacity_factor=cf, act=act)
    want_out, want_aux = j_moe_ffn(jp, jx, n_groups=G, **kw)
    j_routing, j_y, j_out, capacity = _jax_parts(jp, jx, n_groups=G, **kw)
    # the step-by-step copy is the reference
    np.testing.assert_array_equal(np.asarray(j_out, np.float32),
                                  np.asarray(want_out, np.float32))

    xg = tx.reshape(G, -1, D)
    routing = moe.route(tp["router"], xg, top_k, capacity)
    # ties at the top-k boundary: jax.lax.top_k puts the lower index first
    # and torch.topk promises no order; f32 softmax of random routers has
    # none, so the ids must agree exactly
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.einsum(
        "gtd,de->gte", jx.reshape(G, -1, D).astype(jnp.float32), jp["router"]))), -1)
    assert (np.diff(probs, axis=-1) != 0).all()
    for key in ("expert_idx", "positions", "keep", "slot_tok"):
        got = routing[key].numpy()
        want = np.asarray(j_routing[key])
        if key == "slot_tok":               # the trash column holds any dropped token
            got, want = got[..., :capacity], want[..., :capacity]
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)
    _close(routing["gate_vals"], j_routing["gate_vals"], 2e-6)
    if cf < 1.0:
        assert not routing["keep"].all()       # this case does drop claims

    y = moe.experts(tp, moe.dispatch(xg, routing["slot_tok"], capacity), act)
    assert y.dtype == TORCH_DT[dt] and tuple(y.shape) == (G, E, capacity, D)
    _close(y, j_y, TOL[dt])
    # combine on the reference's own expert outputs: the f32 gather-and-sum
    # alone
    comb = moe.combine(torch.from_numpy(np.array(j_y, np.float32)).to(TORCH_DT[dt]),
                       routing)
    _close(comb.reshape(B, S, D), np.asarray(j_out, np.float32), 2e-5 if dt == "f32" else 1e-2)

    out, aux = moe.moe_ffn(tp, tx, n_groups=G, **kw)
    assert out.dtype == TORCH_DT[dt] and tuple(out.shape) == (B, S, D)
    _close(out, want_out, TOL[dt])
    _close(aux, want_aux, 2e-6)


def test_init_moe_params_shapes_dtypes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(64, 32, 8, torch.bfloat16, generator=gen, device=torch.device("cpu"))
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (64, 8)
    assert {k: tuple(v.shape) for k, v in p.items() if k != "router"} == {
        "w_gate": (8, 64, 32), "w_up": (8, 64, 32), "w_down": (8, 32, 64)}
    assert all(p[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))
    assert abs(p["w_gate"].float().std().item() - 64 ** -0.5) < 0.02
    assert abs(p["w_down"].float().std().item() - 32 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2])
def test_capture_makes_each_product_one_gemm_node(G):
    B, S, D, F, E, k = 2, 8, 64, 32, 8, 2
    _, tp, _, tx = _moe_inputs(B, S, D, F, E, "f32", seed=5, loud=4.0)

    def fn(params, x):
        return moe.moe_ffn(params, x, top_k=k, capacity_factor=1.25, act="silu", n_groups=G)

    cap = capture(fn, tp, tx, name="moe")
    C = moe.capacity_for(B * S // G, k, 1.25, E)
    gmm = [n for n in cap.graph.nodes if "moe_gmm" in n.meta.get("ops", ())]
    assert len(gmm) == 3
    for n in gmm:
        assert n.kind == "gemm" and n.meta["ops"].count("moe_gmm") == 1
        assert n.meta["rows"] == G * C
        # 2·E·C·D·F, plus the elementwise producers fused into the node (the
        # down product takes silu(h) * u with it): a few ops per element
        assert 2.0 * E * G * C * D * F <= n.flops <= 2.0 * E * G * C * D * F + 8 * E * G * C * F
    # top-k's two outputs leave one node (its getitems join it); the
    # one-hot is elementwise, the running count a reduction
    topk = [n for n in cap.graph.nodes if "topk" in n.meta.get("ops", ())]
    assert len(topk) == 1 and topk[0].kind == "reduce"
    assert topk[0].meta["ops"].count("getitem") == 2
    assert not any(n.meta.get("ops") == ("getitem",) for n in cap.graph.nodes)
    # the slot assignment is one node of its own kind (its four outputs'
    # getitems join it), with no one-hot count or scatter beside it: its
    # expert ids read, its tables written, one rank a claim
    route = [n for n in cap.graph.nodes if "moe_route_slots" in n.meta.get("ops", ())]
    assert len(route) == 1 and route[0].kind == "moe_route_slots"
    assert route[0].meta["ops"].count("getitem") == 4
    assert not any(op in n.meta.get("ops", ()) for n in cap.graph.nodes
                   for op in ("cumsum", "index_put"))
    claims = B * S * k
    assert route[0].flops == claims and route[0].bytes_in == 8 * claims
    assert route[0].bytes_out == 9 * claims + 8 * G * E * (C + 2)
    # replay reproduces the eager call bit for bit (topk's two outputs reach
    # their consumers through the graph)
    want_out, want_aux = fn(tp, tx)
    got_out, got_aux = cap.run(tp, tx)
    assert torch.equal(got_out, want_out) and torch.equal(got_aux, want_aux)
