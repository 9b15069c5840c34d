"""Dense decode attention (B2) and flash attention (B3): the port's plain
versions against the JAX package's jnp layers, its Pallas kernels in
interpret mode and its oracle.  The CUDA kernels are held against the plain
versions on the card in ``test_torch_gpu.py``.

Inputs come from numpy with a fixed seed.  Decode covers both cache forms
(shared ``kv_pos [S]`` + scalar ``q_pos``, per-row ``kv_pos [B, S]`` + ``q_pos
[B]``), ring-buffer positions, empty entries and a sliding window; flash
covers causal, window, ragged lengths and ``q_offset``.  Tolerances as
``tests/test_kernels.py``: 2e-5 in f32, 3e-2 in bf16 (the two frameworks
round bf16 at different places).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode_kernel
from repro.kernels.flash_attention import flash_attention as j_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as jl
from repro_torch.core.capture import capture
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models import layers as tl

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32), dtype=TORCH_DT[dtype])


def _close(got: torch.Tensor, ref, dtype, rows=None):
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    if rows is not None:
        g, r = g[rows], r[rows]
    np.testing.assert_allclose(g, r, atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# B2: dense decode attention
# ---------------------------------------------------------------------------

def _decode_case(dtype, form, B=4, Hq=4, Hkv=2, hd=16, S=32, seed=0):
    """q [B, 1, Hq, hd], caches [B, S, Hkv, hd] and position tables.  Shared
    form: a ring buffer that has wrapped (positions 20..51 at slots
    pos % S) with two empty entries.  Per-row form: rows at different
    depths, one of them wrapped, and an idle row (all -1, compared
    nowhere)."""
    rng = np.random.default_rng(seed)
    cast = NP_DT[dtype]
    q = rng.standard_normal((B, 1, Hq, hd)).astype(cast)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(cast)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(cast)
    if form == "shared":
        pos = np.arange(20, 20 + S, dtype=np.int32)
        kv_pos = np.full((S,), -1, np.int32)
        kv_pos[pos % S] = pos
        kv_pos[[3, 9]] = -1
        q_pos = np.int32(48)                       # entries 49..51 are in the future
        live = np.ones(B, bool)
    else:
        kv_pos = np.full((B, S), -1, np.int32)
        lens = [5, 32, 44, 0]
        for b, n in enumerate(lens):
            pos = np.arange(max(0, n - S), n, dtype=np.int32)
            kv_pos[b, pos % S] = pos
        q_pos = np.array([max(n - 1, 0) for n in lens], np.int32)
        live = np.array(lens) > 0
    return (q, k, v, kv_pos, q_pos), live


def _decode_torch(args, dtype):
    q, k, v, kv_pos, q_pos = args
    return (_t(q, dtype), _t(k, dtype), _t(v, dtype), torch.as_tensor(kv_pos),
            torch.as_tensor(q_pos))


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jnp_layer(dtype, form, window):
    args, live = _decode_case(dtype, form)
    ref = jl.decode_attention(*(jnp.asarray(a) for a in args), window=window)
    q, k, v, kv_pos, q_pos = _decode_torch(args, dtype)
    out = decode_attention_plain(q[:, 0], k, v, kv_pos, q_pos, window)
    _close(out, np.asarray(ref, np.float32)[:, 0], dtype, rows=live)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_kernel(dtype, window):
    """The TPU kernel takes the shared form only (and needs block_k to tile
    S)."""
    args, _ = _decode_case(dtype, "shared")
    ref = j_decode_kernel(*(jnp.asarray(a) for a in args), window=window, block_k=16,
                          interpret=True)
    out = tl.decode_attention(*_decode_torch(args, dtype), window=window)
    _close(out, ref, dtype)


@pytest.mark.parametrize("form", ["shared", "per_row"])
def test_decode_custom_op_and_layouts(form):
    args, live = _decode_case("float32", form)
    q, k, v, kv_pos, q_pos = _decode_torch(args, "float32")
    ref = decode_attention_plain(q[:, 0], k, v, kv_pos, q_pos)
    via_op = torch.ops.repro_torch.decode_attention(q[:, 0].contiguous(), k, v, kv_pos,
                                                    q_pos, None)
    via_model = decode_attention(q, k, v, kv_pos.long(), q_pos.long())[:, 0]
    m = torch.as_tensor(live)
    assert torch.equal(via_op[m], ref[m]) and torch.equal(via_model[m], ref[m])


# ---------------------------------------------------------------------------
# B3: flash attention
# ---------------------------------------------------------------------------

def _flash_case(dtype, Sq, Skv, B=2, Hq=4, Hkv=2, hd=16, seed=1):
    rng = np.random.default_rng(seed)
    cast = NP_DT[dtype]
    return tuple(rng.standard_normal(s).astype(cast)
                 for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))


def _flash_torch(args, dtype):
    return tuple(_t(a, dtype) for a in args)


# (Sq, Skv, causal, window, q_offset, chunk, q_chunk): chunked in both
# directions, ragged lengths the chunks do not tile (the reference falls
# back to one chunk), a window, and a query block that starts mid-sequence
FLASH_CASES = [
    (32, 32, True, None, 0, 8, 16),
    (37, 37, True, None, 0, 16, 16),
    (32, 32, True, 7, 0, 8, 8),
    (24, 40, True, 11, 16, 8, 8),
    (20, 36, False, None, 0, 12, 10),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_chunked_attention(dtype, case):
    Sq, Skv, causal, window, q_offset, chunk, q_chunk = case
    args = _flash_case(dtype, Sq, Skv)
    ref = jl.chunked_attention(*(jnp.asarray(a) for a in args), causal=causal, window=window,
                               q_offset=q_offset, chunk=chunk, q_chunk=q_chunk)
    out = flash_attention_plain(*_flash_torch(args, dtype), causal, window, q_offset, chunk,
                                q_chunk)
    _close(out, ref, dtype)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_attention_ref(case):
    Sq, Skv, causal, window, q_offset, chunk, q_chunk = case
    args = _flash_case("float32", Sq, Skv)
    ref = attention_ref(*(jnp.asarray(a) for a in args), causal=causal, window=window,
                        q_offset=q_offset)
    out = tl.chunked_attention(*_flash_torch(args, "float32"), causal=causal, window=window,
                               q_offset=q_offset, chunk=chunk, q_chunk=q_chunk)
    _close(out, ref, "float32")


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_kernel(dtype, window):
    """The TPU kernel needs its blocks to tile both lengths."""
    args = _flash_case(dtype, 32, 32)
    ref = j_flash_kernel(*(jnp.asarray(a) for a in args), causal=True, window=window,
                         block_q=16, block_k=8, interpret=True)
    out = flash_attention(*_flash_torch(args, dtype), window=window, chunk=8, q_chunk=16)
    _close(out, ref, dtype)


def test_attention_ops_are_one_graph_node_each():
    """Capture sees each kernel call as one 'attention' node with its flops."""
    args = _flash_torch(_flash_case("float32", 16, 16), "float32")
    dec, _ = _decode_case("float32", "per_row")
    dq, dk, dv, dpos, dqpos = _decode_torch(dec, "float32")

    def fn(q, k, v, dq, dk, dv, dpos, dqpos):
        return (tl.chunked_attention(q, k, v, window=5),
                tl.decode_attention(dq, dk, dv, dpos, dqpos))

    g = capture(fn, *args, dq, dk, dv, dpos, dqpos).graph
    att = {n: g[n] for n in g.names if g[n].kind == "attention"}
    assert sorted(n.split(".")[0] for n in att) == ["decode_attention", "flash_attention"]
    assert all(node.flops > 0 for node in att.values())
