"""Tests that need a CUDA card: the hand-written kernels (B1 paged decode,
B2 dense decode, B3 flash attention, B4 LSTM cell, B5 grouped expert
matmul, B6 selective scan, B7 RG-LRU scan; MoE routing's slot assignment)
against their plain versions, and the executors on CUDA streams against
the sequential oracle.

They import nothing of JAX, so the machine with the card runs them
(``python -m pytest -q -m gpu tests/test_torch_gpu.py``); here they skip.
Tolerances: 2e-5 in f32, 3e-2 in bf16 (the kernel keeps probabilities in
f32 where the plain version rounds them to bf16).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention, decode_attention_cuda,
                                                  decode_attention_plain,
                                                  paged_decode_attention,
                                                  paged_decode_attention_cuda,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 flash_attention_path, flash_attention_plain)
from repro_torch.kernels.lstm_cell import lstm_cell_cuda, lstm_cell_fused, lstm_cell_plain
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_cuda, moe_gmm_path, moe_gmm_plain
from repro_torch.kernels.moe_route import (MAX_EXPERTS, route_slots, route_slots_cuda,
                                           route_slots_plain)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_cuda, rglru_scan_plain
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_cuda, ssm_scan_plain
from torch_route_cases import SLOT_CASES, SLOT_IDS, assert_trash, slot_ids

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU path)")
    return torch.device("cuda")


def _case(dtype, B=5, Hq=4, Hkv=2, hd=16, ps=8, n_pt=4, seed=0):
    """Mixed lengths, row 3 sharing row 2's first pages, row 4 idle."""
    rng = np.random.default_rng(seed)
    P = B * n_pt
    q = torch.as_tensor(rng.standard_normal((B, Hq, hd)), dtype=dtype)
    k = torch.as_tensor(rng.standard_normal((P, ps, Hkv, hd)), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((P, ps, Hkv, hd)), dtype=dtype)
    table = np.full((B, n_pt), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    lengths = [3, 17, 31, 11, 0]
    pages = iter(rng.permutation(P))
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[b, j] = next(pages)
        q_pos[b] = max(n - 1, 0)
    table[3, :2] = table[2, :2]
    live = torch.tensor([n > 0 for n in lengths])
    return (q, k, v, torch.as_tensor(table), torch.as_tensor(q_pos)), live


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, dtype, window):
    args, live = _case(dtype)
    dev_args = [a.to(cuda) for a in args]
    before = paged_decode_attention_cuda.launches
    out = paged_decode_attention(*dev_args, window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    ref = paged_decode_attention_plain(*dev_args, window=window)
    # every row, the idle one (row 4, nothing mapped) included: it gets the
    # plain version's mean of page 0's V, since a MoE FFN routes it too
    assert not live.all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.isfinite(out).all()


def _cluster_case(dtype, hd, B=8, Hq=8, Hkv=2, ps=16, n_pt=40, seed=3):
    """Paged rows on a table of 640 entries, enough for a full cluster of 8
    CTAs: 1 entry, exactly 1 page, a mid-page end, the full table, a row
    sharing the full row's first 9 pages, a row with an unmapped page inside
    its live range, a mid-length row and an idle row (nothing mapped)."""
    rng = np.random.default_rng(seed)
    P = B * n_pt
    q = torch.as_tensor(rng.standard_normal((B, Hq, hd)), dtype=dtype)
    k = torch.as_tensor(rng.standard_normal((P, ps, Hkv, hd)), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((P, ps, Hkv, hd)), dtype=dtype)
    lengths = [1, ps, 100, n_pt * ps, 300, 301, 555, 0]
    table = np.full((B, n_pt), -1, np.int32)
    pages = iter(rng.permutation(P))
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[b, j] = next(pages)
    table[4, :9] = table[3, :9]
    table[5, 7] = -1
    q_pos = np.array([max(n - 1, 0) for n in lengths], np.int32)
    return q, k, v, torch.as_tensor(table), torch.as_tensor(q_pos)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("hd", [64, 100])        # 100: rows not 16-byte aligned in bf16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_fills_a_cluster(cuda, dtype, hd, window):
    """Every row against the plain version (with a window of 200 the long
    rows' windows start mid-range), two calls bit-equal, one launch each."""
    from repro_torch.kernels.decode_attention import decode_split

    args = [a.to(cuda) for a in _cluster_case(dtype, hd)]
    n_pt, ps = args[3].shape[1], args[1].shape[1]
    assert decode_split(n_pt * ps, args[0].element_size(), hd)[0] == 8
    before = paged_decode_attention_cuda.launches
    out = paged_decode_attention_cuda(*args, window)
    again = paged_decode_attention_cuda(*args, window)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 2
    ref = paged_decode_attention_plain(*args, window)
    for b in range(out.shape[0]):
        torch.testing.assert_close(out[b].float(), ref[b].float(), atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m, b=b: f"row {b}: {m}")
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_cannot_take(cuda):
    args, _ = _case(torch.float32)
    q, k, v, table, q_pos = (a.to(cuda) for a in args)
    with pytest.raises(TypeError):
        paged_decode_attention_cuda(q, k, v, table.long(), q_pos)
    with pytest.raises(ValueError):
        paged_decode_attention_cuda(q, k.transpose(1, 2), v, table, q_pos)


@pytest.mark.gpu
def test_stream_executors_match_the_sequential_oracle(cuda):
    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_paged_decode_step

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device=cuda)
    cache = transformer.init_paged_cache(cfg, 3, 64, n_pages=24, page_size=8, device=cuda)
    table = np.full((3, 8), -1, np.int32)
    table[0, :2], table[1, :1] = [5, 7], [9]
    dcache = {"len": torch.tensor([10, 4, 0], dtype=torch.int32, device=cuda),
              "table": torch.as_tensor(table, device=cuda), "pages": cache["pages"]}
    tokens = torch.tensor([[3], [7], [0]], dtype=torch.int32, device=cuda)
    step = make_paged_decode_step(cfg, 8)
    with Runtime(n_workers=3, device=cuda) as rt:
        exe = rt_compile(step, params, dcache, tokens, runtime=rt, jit_nodes=True,
                         n_executors=3, team_size=1)
        inputs = exe.captured.bind((params, dcache, tokens))
        ref = exe.captured.unflatten(exe.graph.execute(inputs))
        for mode in ("static", "dynamic"):
            got = exe.captured.unflatten(exe.execute_host(inputs, host_mode=mode).outputs)
            assert torch.equal(got[0], ref[0])
            for a, b in zip(got[1]["pages"], ref[1]["pages"]):
                assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def _dense_case(dtype, form, B=4, Hq=8, Hkv=2, hd=64, S=200, seed=0):
    """Shared form: a wrapped ring buffer with empty entries and future
    entries; per-row form: rows at different depths (one wrapped) and an
    idle row.  S is no multiple of the kernel's split size."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, Hq, hd)), dtype=dtype)
    k = torch.as_tensor(rng.standard_normal((B, S, Hkv, hd)), dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((B, S, Hkv, hd)), dtype=dtype)
    if form == "shared":
        pos = np.arange(90, 90 + S, dtype=np.int32)
        kv_pos = np.full((S,), -1, np.int32)
        kv_pos[pos % S] = pos
        kv_pos[[3, 77]] = -1
        q_pos = np.int32(250)
        live = np.ones(B, bool)
    else:
        lens = [5, 200, 333, 0]
        kv_pos = np.full((B, S), -1, np.int32)
        for b, n in enumerate(lens):
            p = np.arange(max(0, n - S), n, dtype=np.int32)
            kv_pos[b, p % S] = p
        q_pos = np.array([max(n - 1, 0) for n in lens], np.int32)
        live = np.array(lens) > 0
    return (q, k, v, torch.as_tensor(kv_pos), torch.as_tensor(q_pos)), torch.as_tensor(live)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_matches_plain(cuda, dtype, form, window):
    args, live = _dense_case(dtype, form)
    dev_args = [a.to(cuda) for a in args]
    before = dict(decode_attention_cuda.launches_by_form)
    out = decode_attention(*dev_args, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches_by_form[form] == before[form] + 1
    ref = decode_attention_plain(*dev_args, window=window)
    # every row, the idle one (per_row row 3) included: it gets the mean of V
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.isfinite(out).all()
    again = decode_attention(*dev_args, window=window)
    assert torch.equal(out, again)                 # fixed reduction order


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 120, 128, 256])   # every instantiation; 120 pads
@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_takes_every_head_dim(cuda, dtype, form, hd):
    args, _ = _dense_case(dtype, form, hd=hd)
    dev_args = [a.to(cuda) for a in args]
    out = decode_attention_cuda(*dev_args, None)
    ref = decode_attention_plain(*dev_args, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(out, decode_attention_cuda(*dev_args, None))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_ragged_cache_length(cuda, dtype):
    """gemma-2b widths over S = 1000 entries, no multiple of chunk x n_c
    (64 x 8 in bf16, 32 x 8 in f32): rows end anywhere, one is idle."""
    from repro_torch.kernels.decode_attention import decode_split

    rng = np.random.default_rng(5)
    B, Hq, Hkv, hd, S = 6, 8, 1, 256, 1000
    n_c, chunk = decode_split(S, torch.tensor([], dtype=dtype).element_size(), hd)
    assert S % (n_c * chunk)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh), dtype=dtype, device=cuda)
               for sh in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    lens = [1000, 999, 513, 64, 7, 0]
    kv_pos = torch.full((B, S), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32)
    kv_pos, q_pos = kv_pos.to(cuda), q_pos.to(cuda)
    out = decode_attention_cuda(q, k, v, kv_pos, q_pos, None)
    ref = decode_attention_plain(q, k, v, kv_pos, q_pos, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(out, decode_attention_cuda(q, k, v, kv_pos, q_pos, None))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [40, 64, 100, 300, 1024])   # clusters of 1, 1, 2, 5 and 8 CTAs
@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_rows_without_a_kept_entry_take_the_mean(cuda, dtype, form, S):
    """Every row keeps nothing (empty entries, the future, or outside the
    window): each writes the plain version's uniform mean of V over all S
    entries of its KV head."""
    rng = np.random.default_rng(S)
    B, Hq, Hkv, hd = 3, 4, 2, 64
    q = torch.as_tensor(rng.standard_normal((B, Hq, hd)), dtype=dtype, device=cuda)
    k = torch.as_tensor(rng.standard_normal((B, S, Hkv, hd)), dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.standard_normal((B, S, Hkv, hd)) + 0.5, dtype=dtype, device=cuda)
    pos = np.arange(S, dtype=np.int32) + 10
    pos[::3] = -1
    if form == "shared":
        kv_pos, q_pos, window = torch.as_tensor(pos), torch.tensor(5, dtype=torch.int32), None
    else:
        kv_pos = torch.as_tensor(np.stack([pos, np.full(S, -1, np.int32), pos]))
        q_pos, window = torch.tensor([5, 7, S + 40], dtype=torch.int32), 20
    kv_pos, q_pos = kv_pos.to(cuda), q_pos.to(cuda)
    out = decode_attention_cuda(q, k, v, kv_pos, q_pos, window)
    ref = decode_attention_plain(q, k, v, kv_pos, q_pos, window)
    mean = v.float().mean(dim=1).repeat_interleave(Hq // Hkv, dim=1)
    torch.testing.assert_close(ref.float(), mean, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(out, decode_attention_cuda(q, k, v, kv_pos, q_pos, window))


FRONTEND_DECODE = [   # (Hq, Hkv, hd, S): the frontend archs' decode self-attention
    (16, 16, 64, 48),     # whisper-medium: G = 1, a 48-entry cache (32 + 16 tokens)
    (56, 8, 128, 2952),   # llava-next-34b: G = 7, 2880 image rows + 64 + 8 tokens
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRONTEND_DECODE)
@pytest.mark.parametrize("form", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_at_the_frontend_heads(cuda, dtype, form, case):
    """G = 1 (one query head a KV head) and G = 7 (an odd head group) in
    the split-K core's head mapping: shared, every row 3 entries short of
    the cache (as the frontend steps' rows are before the last); per row,
    rows full, half full, one entry deep and idle."""
    Hq, Hkv, hd, S = case
    B = 4
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh), dtype=dtype, device=cuda)
               for sh in ((B, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    if form == "shared":
        kv_pos = torch.where(torch.arange(S) < S - 3, torch.arange(S), -1).to(torch.int32)
        q_pos = torch.tensor(S - 4, dtype=torch.int32)
    else:
        lens = [S, S // 2, 1, 0]
        kv_pos = torch.full((B, S), -1, dtype=torch.int32)
        for b, n in enumerate(lens):
            kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32)
    kv_pos, q_pos = kv_pos.to(cuda), q_pos.to(cuda)
    before = decode_attention_cuda.launches_by_form[form]
    out = decode_attention_cuda(q, k, v, kv_pos, q_pos, None)
    assert decode_attention_cuda.launches_by_form[form] == before + 1
    ref = decode_attention_plain(q, k, v, kv_pos, q_pos, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(out, decode_attention_cuda(q, k, v, kv_pos, q_pos, None))


@pytest.mark.gpu
def test_dense_decode_kernel_rejects_what_it_cannot_take(cuda):
    (q, k, v, kv_pos, q_pos), _ = _dense_case(torch.float32, "per_row")
    q, k, v, kv_pos, q_pos = (a.to(cuda) for a in (q, k, v, kv_pos, q_pos))
    with pytest.raises(TypeError):
        decode_attention_cuda(q, k, v, kv_pos.long(), q_pos)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, k, v, kv_pos, q_pos[0])       # [B, S] with a scalar q_pos
    with pytest.raises(ValueError):
        decode_attention_cuda(q, k.transpose(1, 2), v, kv_pos, q_pos)
    for hd, ok in ((120, True), (100, False), (264, False)):   # bf16: 16-byte rows, <= 256
        (q, k, v, kv_pos, q_pos), _ = _dense_case(torch.bfloat16, "per_row", hd=hd)
        args = [a.to(cuda) for a in (q, k, v, kv_pos, q_pos)]
        if ok:
            assert decode_attention_cuda(*args).shape == q.shape
        else:
            with pytest.raises(ValueError):
                decode_attention_cuda(*args)


FLASH_CASES = [   # (Sq, Skv, causal, window, q_offset)
    (128, 128, True, None, 0),
    (97, 97, True, None, 0),
    (333, 333, True, 64, 0),
    (40, 100, True, 30, 60),
    (70, 50, False, None, 0),
    (1100, 1100, True, None, 0),   # 144 tiles of 64 rows fill an H100: the 64-row form
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("hd", [16, 64, 128, 256, 120, 60])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype, hd, case):
    """Every head width the main paths use (gemma and recurrentgemma 256,
    granite 64, olmoe 128, h2o-danube3-4b 120: padded to 128) in both kernel
    forms: bf16 on the tensor cores, f32 (and bf16 at hd 60, whose rows are
    not whole 16-byte chunks) on the CUDA cores."""
    Sq, Skv, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((2, Sq, 4, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, Skv, 2, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, Skv, 2, hd), generator=gen, device=cuda).to(dtype)
    before = flash_attention_cuda.launches
    path = flash_attention_path(dtype, hd)
    assert path == ("mma" if dtype == torch.bfloat16 and hd % 8 == 0 else "simt")
    before_path = flash_attention_cuda.launches_by_path[path]
    out = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.launches_by_path[path] == before_path + 1
    ref = flash_attention_plain(q, k, v, causal, window, q_offset)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    # one thread sums each output in a fixed order: the same bits every call
    assert torch.equal(flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset), out)


FRONTEND_FLASH = [   # (B, Sq, Skv, causal, Hq, Hkv, hd)
    (4, 1500, 1500, False, 16, 16, 64),   # whisper-medium's encoder: 23 key tiles + 28
    (4, 32, 1500, False, 16, 16, 64),     # its cross-attention of a 32-token prompt
    (4, 1, 1500, False, 16, 16, 64),      # and of one decode row (one live row a tile)
    (2, 2944, 2944, True, 56, 8, 128),    # llava-next-34b: 2880 image rows + 64 tokens
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRONTEND_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_frontend_shapes(cuda, dtype, case):
    """The frontend archs' prefill and cross-attention at full width: the
    non-causal form with Sq = Skv, Sq < Skv and Sq = 1 (G = 1, hd 64), and
    a ragged causal prefill at G = 7, hd 128; each on its form, the same
    bits twice.  f32 against the plain version; bf16 against the plain
    version run in f32 on the same bf16 inputs, within 4 bf16 ulps of each
    output row's largest value (the kernel rounds only P and its output;
    a skipped last key tile at whisper's 1500 keys is ~30 such ulps off)."""
    B, Sq, Skv, causal, Hq, Hkv, hd = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, Hq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device=cuda).to(dtype)
    path = flash_attention_path(dtype, hd)
    before = flash_attention_cuda.launches_by_path[path]
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_path[path] == before + 1
    if dtype == torch.float32:
        ref = flash_attention_plain(q, k, v, causal, None, 0, 1024, 512)
        torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    else:
        exact = flash_attention_plain(q.float(), k.float(), v.float(), causal, None, 0, 1024, 512)
        top = exact.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -126)
        ulps = (out.float() - exact).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)
        assert ulps.max().item() <= 4, f"{ulps.max().item():.2f} bf16 ulps of a row's largest value"
    assert torch.equal(flash_attention(q, k, v, causal=causal), out)


@pytest.mark.gpu
def test_flash_kernel_fp16_takes_the_tensor_cores(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((1, 150, 4, 128), generator=gen, device=cuda).half()
    k = torch.randn((1, 150, 1, 128), generator=gen, device=cuda).half()
    v = torch.randn((1, 150, 1, 128), generator=gen, device=cuda).half()
    before = flash_attention_cuda.launches_by_path["mma"]
    out = flash_attention_cuda(q, k, v, True, None, 0)
    assert flash_attention_cuda.launches_by_path["mma"] == before + 1
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, True).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 257), device=cuda)
    with pytest.raises(ValueError):                 # no compiled width holds hd 257
        flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q[:, :, :2].contiguous().half(), q[:, :, :2].contiguous())
    flat = torch.zeros(1 + 8 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    qb = flat[1:].view(1, 8, 4, 64)                 # contiguous, but 2 bytes off a row
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_cuda(qb, qb[:, :, :2].contiguous(), qb[:, :, :2].contiguous())


@pytest.mark.gpu
def test_slot_decode_step_on_streams_matches_the_sequential_oracle(cuda):
    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device=cuda)
    cache = transformer.init_cache(cfg, 3, 64, per_slot=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for lc in cache["layers"]:
        lc["k"].normal_(generator=gen)
        lc["v"].normal_(generator=gen)
        lc["pos"][0, :10] = torch.arange(10, device=cuda)
        lc["pos"][1, :3] = torch.arange(3, device=cuda)
    cache["len"] = torch.tensor([10, 3, 0], dtype=torch.int32, device=cuda)
    tokens = torch.tensor([[3], [7], [0]], dtype=torch.int32, device=cuda)
    with Runtime(n_workers=3, device=cuda) as rt:
        exe = rt_compile(make_decode_step(cfg), params, cache, tokens, runtime=rt,
                         jit_nodes=True, n_executors=3, team_size=1)
        inputs = exe.captured.bind((params, cache, tokens))
        ref = exe.captured.unflatten(exe.graph.execute(inputs))
        for mode in ("static", "dynamic"):
            got = exe.captured.unflatten(exe.execute_host(inputs, host_mode=mode).outputs)
            assert torch.equal(got[0], ref[0])
            for a, b in zip(got[1]["layers"], ref[1]["layers"]):
                assert all(torch.equal(a[kk], b[kk]) for kk in ("k", "v", "pos"))


@pytest.mark.gpu
def test_overlapped_admissions_serve_the_same_streams_as_serial_ones(cuda):
    """An admission prefill that overlaps a decode step runs on a worker
    thread's executor streams, and the engine thread installs its cache
    after the step: the streams must equal those of a run where every
    prefill comes before the first decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve import ContinuousEngine, Request, ServeConfig

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device=cuda)
    for lp in params["layers"]:          # louder blocks: streams depend on the cache
        lp["attn"]["wo"] *= 16.0
        lp["mlp"]["w_down"] *= 16.0
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (5, 23, 30, 12)]
    with Runtime(n_workers=2, device=cuda) as rt:
        eng = ContinuousEngine(cfg, params, ServeConfig(max_batch=4, max_len=64),
                               device=cuda, runtime=rt)

        def serve(first: int) -> list:
            for i in range(first):
                eng.submit(Request(i, prompts[i], max_new_tokens=8))
            if first < len(prompts):
                eng.step()                   # admits the first requests
                eng.step()                   # decodes them
                for i in range(first, len(prompts)):
                    eng.submit(Request(i, prompts[i], max_new_tokens=8))
            return [r.output for r in eng.run()]

        serial = serve(len(prompts))
        assert eng.stats()["n_overlapped_prefills"] == 0
        overlapped = serve(1)
        assert eng.stats()["n_overlapped_prefills"] == len(prompts) - 1
    assert overlapped == serial
    assert len({t for s in serial for t in s}) > 4


# gates (and bias), state dtypes; (N, H) — H = 200 and 3 take the scalar path
LSTM_DTYPES = [(torch.float32,) * 2, (torch.bfloat16,) * 2,
               (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
# (256, 1024): the stacked wavefront's L x B rows; (67, 1000): a last CTA
# only partly full
LSTM_SHAPES = [(64, 1024), (256, 64), (37, 200), (1, 3), (1, 1024), (256, 1024), (67, 1000)]


def _lstm_inputs(dtypes, N, H, device, seed=0):
    gdt, cdt = dtypes
    gen = torch.Generator(device=device).manual_seed(seed + N * 7 + H)
    gx = torch.randn((N, 4 * H), generator=gen, device=device).to(gdt)
    gh = torch.randn((N, 4 * H), generator=gen, device=device).to(gdt)
    b = torch.randn((4 * H,), generator=gen, device=device).to(gdt)
    c = torch.randn((N, H), generator=gen, device=device).to(cdt)
    return gx, gh, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LSTM_SHAPES)
@pytest.mark.parametrize("dtypes", LSTM_DTYPES)
def test_lstm_cell_kernel_matches_plain(cuda, dtypes, shape):
    gx, gh, b, c = _lstm_inputs(dtypes, *shape, cuda)
    before = lstm_cell_cuda.launches
    h, c_new = lstm_cell_fused(gx, gh, b, c)
    torch.cuda.synchronize()
    assert lstm_cell_cuda.launches == before + 1
    assert h.dtype == gx.dtype and c_new.dtype == c.dtype
    h_ref, c_ref = lstm_cell_plain(gx, gh, b, c)
    tol = TOL[torch.bfloat16 if torch.bfloat16 in dtypes else torch.float32]
    torch.testing.assert_close(h.float(), h_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(c_new.float(), c_ref.float(), atol=tol, rtol=tol)
    again = lstm_cell_cuda(gx, gh, b, c)
    assert torch.equal(again[0], h) and torch.equal(again[1], c_new)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 1024), (37, 200), (3, 7)])
@pytest.mark.parametrize("dtypes", [(torch.float32,) * 2, (torch.bfloat16, torch.float32)])
def test_lstm_cell_kernel_every_grid_matches_plain(cuda, dtypes, shape):
    """Every grid the kernel takes (columns a thread x threads a CTA), not
    only the one ``cell_tiles`` picks, within the tolerance of the plain
    version and the same bits on two calls."""
    from repro_torch.kernels.lstm_cell import ops

    gx, gh, b, c = _lstm_inputs(dtypes, *shape, cuda)
    h_ref, c_ref = lstm_cell_plain(gx, gh, b, c)
    tol = TOL[dtypes[0]]
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for cols in (1, 2, 4):
        for threads in (32, 64, 128, 256):
            outs = []
            for _ in range(2):
                h, c_new = torch.empty_like(h_ref), torch.empty_like(c_ref)
                err = ops._lib().lstm_cell_fwd(
                    gx.data_ptr(), gh.data_ptr(), b.data_ptr(), c.data_ptr(), h.data_ptr(),
                    c_new.data_ptr(), codes[dtypes[0]], codes[dtypes[1]], *shape, cols,
                    threads, torch.cuda.current_stream().cuda_stream)
                assert err == 0, (cols, threads)
                outs.append((h, c_new))
            torch.testing.assert_close(outs[0][0].float(), h_ref.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(outs[0][1].float(), c_ref.float(), atol=tol, rtol=tol)
            assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.gpu
def test_lstm_cell_kernel_takes_unaligned_views(cuda):
    """A contiguous view 4 bytes into its storage cannot take the vector
    loads: the kernel must walk it one element at a time, and agree."""
    N, H = 8, 64
    buf = torch.randn(1 + 2 * N * 4 * H + 4 * H + N * H, device=cuda)
    gx = buf[1:1 + N * 4 * H].view(N, 4 * H)
    gh = buf[1 + N * 4 * H:1 + 2 * N * 4 * H].view(N, 4 * H)
    b = buf[1 + 2 * N * 4 * H:1 + 2 * N * 4 * H + 4 * H]
    c = buf[1 + 2 * N * 4 * H + 4 * H:].view(N, H)
    h, c_new = lstm_cell_cuda(gx, gh, b, c)
    h_ref, c_ref = lstm_cell_plain(gx, gh, b, c)
    torch.testing.assert_close(h, h_ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(c_new, c_ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_lstm_cell_kernel_rejects_what_it_cannot_take(cuda):
    gx, gh, b, c = _lstm_inputs((torch.float32,) * 2, 4, 8, cuda)
    with pytest.raises(TypeError):                  # no f16 build
        lstm_cell_cuda(gx.half(), gh.half(), b.half(), c)
    with pytest.raises(TypeError):                  # gh must share gx's dtype
        lstm_cell_cuda(gx, gh.bfloat16(), b, c)
    with pytest.raises(TypeError):                  # and so must the bias
        lstm_cell_cuda(gx, gh, b.bfloat16(), c)
    with pytest.raises(ValueError):                 # c is not [N, H]
        lstm_cell_cuda(gx, gh, b, c[:, :4].contiguous())
    with pytest.raises(ValueError):                 # gates not [N, 4H]
        lstm_cell_cuda(gx[:, :30].contiguous(), gh[:, :30].contiguous(), b, c)
    with pytest.raises(ValueError):
        lstm_cell_cuda(gx.t().contiguous().t(), gh, b, c)
    with pytest.raises(ValueError, match="needs CUDA"):
        lstm_cell_cuda(gx.cpu(), gh.cpu(), b.cpu(), c.cpu())


@pytest.mark.gpu
def test_compiled_sequential_lstm_on_streams_matches_the_sequential_oracle(cuda):
    from repro_torch.api import compile as rt_compile
    from repro_torch.core.cost_model import H100
    from repro_torch.core.wavefront import sequential_lstm, stacked_wavefront_lstm
    from repro_torch.runtime import Runtime

    L, T, B, H = 3, 6, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    stacked = {k: torch.randn(shape, generator=gen, device=cuda) * 0.1
               for k, shape in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)), ("b", (L, 4 * H)))}
    per_layer = [{k: v[l].contiguous() for k, v in stacked.items()} for l in range(L)]
    xs = torch.randn((T, B, H), generator=gen, device=cuda)
    with Runtime(n_workers=3, device=cuda) as rt:
        exe = rt_compile(sequential_lstm, per_layer, xs, hw=H100, runtime=rt, jit_nodes=True,
                         host_mode="static")
        inputs = exe.captured.bind((per_layer, xs))
        before = lstm_cell_cuda.launches
        ref = exe.captured.unflatten(exe.graph.execute(inputs))
        assert lstm_cell_cuda.launches == before + L * T
        for mode in ("static", "dynamic"):
            got = exe.captured.unflatten(exe.execute_host(inputs, host_mode=mode).outputs)
            assert torch.equal(got, ref)
    torch.testing.assert_close(stacked_wavefront_lstm(stacked, xs, L), ref, atol=1e-4, rtol=0)


# -- B5: grouped per-expert matmul --------------------------------------------

# (E, C, D, F, dtype): granite-moe-1b-a400m's decode step (8 slots) in both
# product forms, a paged chunk of 128 (C = 40), slot prefills (C = 104) and
# wave prefills (C = 256, 416); f32; ragged shapes no tile divides, on the
# tensor cores (C = 5, 13, 29 and 37: the narrow kernel at 8, 16, 32 and 64
# slots; C = 100: a wide tile) and on the SIMT kernel (D or F not a
# multiple of 8, f32)
MOE_GMM_CASES = [(32, 8, 1024, 512, torch.bfloat16), (32, 8, 512, 1024, torch.bfloat16),
                 (32, 40, 1024, 512, torch.bfloat16), (32, 104, 1024, 512, torch.bfloat16),
                 (32, 256, 512, 1024, torch.bfloat16), (32, 416, 1024, 512, torch.bfloat16),
                 (32, 104, 1024, 512, torch.float32),
                 (3, 37, 200, 72, torch.bfloat16), (3, 5, 200, 72, torch.bfloat16),
                 (3, 13, 136, 200, torch.bfloat16), (3, 29, 136, 72, torch.bfloat16),
                 (3, 100, 200, 72, torch.bfloat16), (3, 37, 201, 73, torch.bfloat16),
                 (3, 37, 201, 73, torch.float32), (2, 1, 5, 3, torch.float32)]


def _gmm_inputs(E, C, D, F, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((E, C, D), generator=gen, device=device).to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device=device) * D ** -0.5).to(dtype)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_GMM_CASES)
def test_moe_gmm_kernel_matches_plain(cuda, case):
    E, C, D, F, dtype = case
    x, w = _gmm_inputs(E, C, D, F, dtype, cuda)
    before = moe_gmm_cuda.launches
    path = moe_gmm_path(x, w)
    assert path == ("mma" if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
                    else "simt")
    before_path = moe_gmm_cuda.launches_by_path[path]
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm_cuda.launches == before + 1
    assert moe_gmm_cuda.launches_by_path[path] == before_path + 1
    assert out.dtype == dtype and tuple(out.shape) == (E, C, F)
    torch.testing.assert_close(out.float(), moe_gmm_plain(x, w).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # one thread sums each output in a fixed order: the same bits every call
    assert torch.equal(moe_gmm_cuda(x, w), out)


@pytest.mark.gpu
def test_moe_gmm_kernel_takes_unaligned_views(cuda):
    """Storage offsets that break 16-byte alignment take the element path."""
    x, w = _gmm_inputs(2, 9, 64, 40, torch.bfloat16, cuda)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    xs.copy_(x)
    assert moe_gmm_path(xs, w) == "simt" and moe_gmm_path(x, w) == "mma"
    torch.testing.assert_close(moe_gmm_cuda(xs, w).float(), moe_gmm_plain(x, w).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.gpu
def test_moe_gmm_kernel_rejects_what_it_cannot_take(cuda):
    x, w = _gmm_inputs(2, 8, 32, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        moe_gmm_cuda(x.half(), w.half())
    with pytest.raises(TypeError):
        moe_gmm_cuda(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match=r"\[E, C, D\]"):
        moe_gmm_cuda(x, w[:, :16])
    with pytest.raises(ValueError, match=r"\[E, C, D\]"):
        moe_gmm_cuda(x, w[:1])


@pytest.mark.gpu
def test_moe_decode_step_launches_b5_three_times_per_layer(cuda):
    """A granite smoke decode step on the card: every MoE layer's three
    expert products are B5 launches, and the f32 logits match the CPU's."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("granite-moe-1b-a400m", smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 4, 32, per_slot=True, device="cpu")
    toks = torch.tensor([[5], [17], [300], [0]], dtype=torch.int32)
    ref, _ = transformer.decode_step(cfg, params, toks, cache)
    before = moe_gmm_cuda.launches
    got, _ = transformer.decode_step(cfg, pytree.tree_map(lambda t: t.to(cuda), params),
                                     toks.to(cuda), pytree.tree_map(lambda t: t.to(cuda), cache))
    torch.cuda.synchronize()
    assert moe_gmm_cuda.launches == before + 3 * cfg.n_layers
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


# -- B6 / B7: the recurrent scans ----------------------------------------------

# (B, S, D, St, c dtype, h0): ragged D and S, every lane-group width (St 1,
# 4 -> 4, 5 -> 8, 16, 32), c in f32 and bf16, from zero and from a state
SSM_CASES = [(2, 37, 200, 16, torch.float32, True), (1, 50, 64, 16, torch.bfloat16, False),
             (8, 1, 96, 16, torch.bfloat16, True), (3, 9, 7, 5, torch.float32, True),
             (2, 20, 33, 32, torch.float32, True), (1, 3, 5, 1, torch.float32, False),
             (2, 17, 9, 4, torch.bfloat16, True)]


def _ssm_inputs(B, S, D, St, c_dtype, h0, device, seed=0):
    """The model's distributions: a = exp(-dt·A), b = dt·B·x."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch.rand((B, S, D, 1), generator=gen, device=device) * 0.099 + 0.001
    a = torch.exp(-dt * torch.arange(1, St + 1, dtype=torch.float32, device=device))
    b = dt * torch.randn((B, S, D, St), generator=gen, device=device)
    c = torch.randn((B, S, St), generator=gen, device=device).to(c_dtype)
    h = torch.randn((B, D, St), generator=gen, device=device) if h0 else None
    return a, b, c, h


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, case):
    a, b, c, h0 = _ssm_inputs(*case, cuda)
    before = ssm_scan_cuda.launches
    y, h = ssm_scan(a, b, c, h0)
    torch.cuda.synchronize()
    assert ssm_scan_cuda.launches == before + 1
    ry, rh = ssm_scan_plain(a, b, c, h0)
    # the recurrence rounds its product and sum apart, as the plain version
    # does: the state is the same bits; y sums the states in another order
    assert torch.equal(h, rh)
    torch.testing.assert_close(y, ry, atol=2e-5, rtol=2e-5)
    y2, h2 = ssm_scan_cuda(a, b, c, h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 31, 32, 33, 333, 512])
@pytest.mark.parametrize("c_dtype,St", [(torch.bfloat16, 16), (torch.float32, 5)])
def test_ssm_scan_training_form_matches_the_serving_kernel(cuda, S, c_dtype, St):
    """The training forward: y and h_last bit-equal to the serving
    kernel's, its checkpoints (the state every 32 steps and at S-1)
    bit-equal to ``ssm_scan_train_plain``'s; counted apart from the
    serving launches."""
    from repro_torch.kernels.ssm_scan import ssm_scan_train_cuda, ssm_scan_train_plain

    a, b, c, h0 = _ssm_inputs(2, S, 70, St, c_dtype, S % 2 == 1, cuda, seed=S)
    y, h = ssm_scan_cuda(a, b, c, h0)
    before = ssm_scan_cuda.launches, ssm_scan_train_cuda.launches
    ty, th, ck = ssm_scan_train_cuda(a, b, c, h0)
    torch.cuda.synchronize()
    assert (ssm_scan_cuda.launches, ssm_scan_train_cuda.launches) == (before[0], before[1] + 1)
    assert torch.equal(ty, y) and torch.equal(th, h)
    assert ck.shape == (2, -(-S // 32), 70, St)
    assert torch.equal(ck, ssm_scan_train_plain(a, b, c, h0)[2])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 29])
def test_scan_kernels_keep_batch_rows_apart(cuda, S):
    """A row of a batch gets the same bits as the row alone: the wave
    engine's batched prefill and the slot engine's one-row prefill run the
    same recurrence."""
    a, b, c, h0 = _ssm_inputs(4, S, 40, 16, torch.bfloat16, True, cuda)
    y, h = ssm_scan_cuda(a, b, c, h0)
    ra, rb, rh0 = _rglru_inputs(4, S, 300, True, cuda)
    hs, hl = rglru_scan_cuda(ra, rb, rh0)
    for i in range(4):
        yi, hi = ssm_scan_cuda(a[i:i + 1], b[i:i + 1], c[i:i + 1], h0[i:i + 1])
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])
        hsi, hli = rglru_scan_cuda(ra[i:i + 1], rb[i:i + 1], rh0[i:i + 1])
        assert torch.equal(hsi, hs[i:i + 1]) and torch.equal(hli, hl[i:i + 1])


@pytest.mark.gpu
def test_ssm_scan_takes_non_contiguous_views(cuda):
    """The op makes strided views contiguous before the kernel."""
    a, b, c, h0 = _ssm_inputs(2, 11, 24, 16, torch.float32, True, cuda)
    at = a.transpose(2, 3).contiguous().transpose(2, 3)
    ct = c.transpose(1, 2).contiguous().transpose(1, 2)
    assert not at.is_contiguous() and not ct.is_contiguous()
    y, h = ssm_scan(at, b, ct, h0)
    ry, rh = ssm_scan_plain(a, b, c, h0)
    assert torch.equal(h, rh)
    torch.testing.assert_close(y, ry, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_ssm_scan_kernel_rejects_what_it_cannot_take(cuda):
    a, b, c, h0 = _ssm_inputs(2, 5, 8, 16, torch.float32, True, cuda)
    with pytest.raises(TypeError):
        ssm_scan_cuda(a, b, c.half(), h0)
    with pytest.raises(TypeError):
        ssm_scan_cuda(a, b, c, h0.bfloat16())
    with pytest.raises(TypeError):
        ssm_scan_cuda(a.bfloat16(), b, c, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_cuda(a.transpose(2, 3).contiguous().transpose(2, 3), b, c, h0)
    with pytest.raises(ValueError, match=r"\[B, S, St\]"):
        ssm_scan_cuda(a, b, c[:, :4], h0)
    a33, b33, c33, _ = _ssm_inputs(1, 2, 4, 33, torch.float32, False, cuda)
    with pytest.raises(ValueError, match="St <= 32"):
        ssm_scan_cuda(a33, b33, c33)
    with pytest.raises(ValueError, match="needs CUDA"):
        ssm_scan_cuda(a.cpu(), b.cpu(), c.cpu())


# recurrentgemma-2b's slot prefill, wave prefill (B = 4) and a 2048-token
# prompt; decode; S not a multiple of the ring's chunk with R not a
# multiple of the channel block, on the 4-byte copies (R = 1030) and the
# 16-byte ones (R = 2052)
RGLRU_CASES = [(1, 333, 2560, False), (8, 1, 2560, True), (2, 37, 200, True), (3, 5, 1, True),
               (1, 70, 4100, False), (4, 333, 2560, False), (1, 2048, 2560, False),
               (3, 101, 1030, True), (2, 77, 2052, False)]


def _rglru_inputs(B, S, R, h0, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((B, S, R), generator=gen, device=device) * 0.999
    b = torch.sqrt(1 - a * a) * torch.randn((B, S, R), generator=gen, device=device)
    h = torch.randn((B, R), generator=gen, device=device) if h0 else None
    return a, b, h


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_scan_kernel_matches_plain(cuda, case):
    """The recurrence rounds its product and sum apart, as the plain version
    does: every state is the same bits."""
    a, b, h0 = _rglru_inputs(*case, cuda)
    before = rglru_scan_cuda.launches
    hs, h = rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 1
    rhs, rh = rglru_scan_plain(a, b, h0)
    assert torch.equal(hs, rhs) and torch.equal(h, rh)
    hs2, h2 = rglru_scan_cuda(a, b, h0)
    assert torch.equal(hs2, hs) and torch.equal(h2, h)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [(4, 8, 1), (4, 8, 2), (8, 32, 3), (16, 64, 4), (32, 128, 6),
                                   (8, 16, 8), (16, 40, 2), (0, 0, 0)])
def test_rglru_scan_kernel_every_tiling_is_bit_equal(cuda, tiles):
    """Tilings the kernel takes besides the ones ``scan_tiles`` picks
    (channels a CTA, steps a stage, ring stages; 0 = the direct form): a
    ring shallower than the chunks, one stage, stages that are not whole
    32-step blocks, blocks that leave a ragged last CTA, on 16-byte (R =
    200) and 4-byte (R = 50) copies; every output bit-equal to the plain
    version."""
    from repro_torch.kernels.rglru_scan import ops

    for B, S, R in ((2, 150, 200), (1, 77, 50)):
        a, b, h0 = _rglru_inputs(B, S, R, True, cuda)
        rhs, rh = rglru_scan_plain(a, b, h0)
        hs, h = torch.empty_like(rhs), torch.empty_like(rh)
        err = ops._lib().rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                        hs.data_ptr(), h.data_ptr(), B, S, R, *tiles,
                                        torch.cuda.current_stream().cuda_stream)
        assert err == 0
        assert torch.equal(hs, rhs) and torch.equal(h, rh), (B, S, R)


@pytest.mark.gpu
def test_rglru_scan_takes_non_contiguous_views(cuda):
    a, b, h0 = _rglru_inputs(3, 9, 40, True, cuda)
    at = a.transpose(0, 2).contiguous().transpose(0, 2)
    assert not at.is_contiguous()
    hs, h = rglru_scan(at, b, h0)
    rhs, rh = rglru_scan_plain(a, b, h0)
    assert torch.equal(hs, rhs) and torch.equal(h, rh)


@pytest.mark.gpu
def test_rglru_scan_kernel_rejects_what_it_cannot_take(cuda):
    a, b, h0 = _rglru_inputs(2, 5, 8, True, cuda)
    with pytest.raises(TypeError):
        rglru_scan_cuda(a.bfloat16(), b.bfloat16(), h0)
    with pytest.raises(TypeError):
        rglru_scan_cuda(a, b, h0.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_cuda(a.transpose(0, 2).contiguous().transpose(0, 2), b, h0)
    with pytest.raises(ValueError, match=r"\[B, R\]"):
        rglru_scan_cuda(a, b, h0[:, :3])
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_scan_cuda(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernel", [("falcon-mamba-7b", "ssm"),
                                         ("recurrentgemma-2b", "rglru")])
def test_recurrent_decode_step_on_streams_matches_the_sequential_oracle(cuda, arch, kernel):
    """A smoke decode step (f32) of a recurrent arch captured and run on 3
    executor streams: static plan, dynamic scheduler and sequential
    ``Graph.execute`` give the same bits, each recurrent layer launches its
    scan kernel once (B6 once per Mamba layer, B7 once per RG-LRU layer),
    and the logits match the CPU's eager step."""
    from torch.utils import _pytree as pytree

    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step

    cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 3, 64, per_slot=True, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for lc in cache["layers"]:
        for kk in ("h", "conv", "k", "v"):
            if kk in lc:
                lc[kk] = torch.randn(lc[kk].shape, generator=gen)
        if "pos" in lc:
            lc["pos"][0, :10] = torch.arange(10)
            lc["pos"][1, :3] = torch.arange(3)
    cache["len"] = torch.tensor([10, 3, 0], dtype=torch.int32)
    tokens = torch.tensor([[3], [7], [0]], dtype=torch.int32)
    want, _ = make_decode_step(cfg)(params, cache, tokens)
    dev = pytree.tree_map(lambda t: t.to(cuda), (params, cache, tokens))
    counter = ssm_scan_cuda if kernel == "ssm" else rglru_scan_cuda
    n_rec = cfg.layer_kinds().count(kernel)
    with Runtime(n_workers=3, device=cuda) as rt:
        exe = rt_compile(make_decode_step(cfg), *dev, runtime=rt, jit_nodes=True,
                         n_executors=3, team_size=1)
        inputs = exe.captured.bind(dev)
        before = counter.launches
        ref = exe.captured.unflatten(exe.graph.execute(inputs))
        torch.cuda.synchronize()
        assert counter.launches == before + n_rec
        for mode in ("static", "dynamic"):
            got = exe.captured.unflatten(exe.execute_host(inputs, host_mode=mode).outputs)
            assert torch.equal(got[0], ref[0])
            for a, b in zip(got[1]["layers"], ref[1]["layers"]):
                assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    torch.testing.assert_close(ref[0].cpu(), want, atol=1e-4, rtol=1e-4)


# -- training: B3's and B4's backward kernels ----------------------------------

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dtype): every head dim,
# G = 1 / 2 / 8 (Hkv > 1 too), ragged and one-token lengths, q_offset,
# non-causal calls, windows, f32 (SIMT) and bf16 / fp16 (tensor cores),
# gemma-2b's training shape; every row keeps a key (the forward writes zeros
# and a floor log-sum-exp for a row that keeps none, the plain version -1e30)
_BWD_CASES = [(2, 40, 40, 4, 2, 16, True, None, 0, torch.float32),
              (1, 97, 97, 8, 1, 256, True, None, 0, torch.bfloat16),
              (2, 64, 64, 4, 1, 64, True, 9, 0, torch.bfloat16),
              (1, 33, 33, 4, 4, 32, True, 5, 0, torch.float32),
              (1, 50, 50, 4, 2, 128, True, None, 0, torch.float16),
              (2, 1, 1, 4, 2, 16, True, None, 0, torch.bfloat16),
              (1, 33, 33, 2, 2, 32, True, None, 0, torch.bfloat16),
              (2, 97, 97, 4, 2, 64, True, None, 0, torch.float16),
              (1, 333, 333, 16, 2, 128, True, None, 0, torch.bfloat16),
              (1, 333, 333, 16, 2, 128, True, 100, 0, torch.float16),
              (2, 40, 100, 4, 2, 256, True, 30, 60, torch.bfloat16),
              (2, 70, 50, 4, 2, 128, False, None, 0, torch.bfloat16),
              (1, 33, 80, 8, 1, 64, False, 20, 7, torch.float16),
              (3, 97, 97, 16, 2, 16, True, None, 5, torch.bfloat16),
              (1, 333, 333, 8, 1, 256, True, None, 0, torch.float32),
              (2, 33, 97, 4, 1, 128, False, None, 0, torch.float32),
              (4, 512, 512, 8, 1, 256, True, None, 0, torch.bfloat16),
              (4, 512, 512, 8, 1, 256, True, 256, 0, torch.bfloat16),
              # h2o-danube3-4b's 32 / 8 heads of 120 (padded to 128) on the
              # tensor cores, and on the CUDA cores in f32; hd 60 in bf16
              # (rows not whole 16-byte chunks: CUDA cores); hd 72 in fp16
              (4, 512, 512, 32, 8, 120, True, None, 0, torch.bfloat16),
              (1, 333, 333, 32, 8, 120, True, 256, 0, torch.bfloat16),
              (2, 97, 97, 32, 8, 120, True, None, 0, torch.float32),
              (2, 97, 97, 4, 2, 60, True, None, 0, torch.bfloat16),
              (1, 200, 200, 4, 1, 72, True, 50, 3, torch.float16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, case):
    """The training forward (output equal to the serving call, its
    log-sum-exp to the plain version's) and the backward kernels against
    ``flash_attention_bwd_plain``, every element of dq, dk and dv; the form
    each call takes (tensor cores for bf16 / fp16, SIMT for f32); the same
    bits twice."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_path,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.flash_attention.ops import _plain_forward

    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dt = case
    rng = np.random.default_rng(Sq + Skv + hd)
    q, do = (torch.as_tensor(rng.standard_normal((B, Sq, Hq, hd)), dtype=dt, device=cuda)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((B, Skv, Hkv, hd)), dtype=dt, device=cuda)
            for _ in range(2))
    tol = 2e-5 if dt == torch.float32 else 3e-2
    out, lse = flash_attention_train_cuda(q, k, v, causal, window, q_offset)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal, window, q_offset))
    torch.testing.assert_close(
        lse, _plain_forward(q, k, v, causal, window, q_offset, 2048, 2048)[1], atol=tol, rtol=0)
    path = flash_attention_bwd_path(dt, hd)
    assert path == ("simt" if dt == torch.float32 or hd % 8 else "mma")
    before = dict(flash_attention_bwd_cuda.launches_by_path)
    args = (do, q, k, v, out, lse, causal, window, q_offset)
    got = flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, flash_attention_bwd_plain(*args)):
        assert a.dtype == dt and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)
    again = flash_attention_bwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash_attention_bwd_cuda.launches_by_path == {
        p: n + 2 * (p == path) for p, n in before.items()}


def _chip_smoke():
    """``chip_smoke.py`` from the repository's root: B3-bwd's frontend
    shapes, their inputs and their bars, shared with the card's smoke run."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


@pytest.mark.gpu
@pytest.mark.parametrize("case", cs.FRONTEND_BWD)
def test_flash_backward_kernel_at_the_frontend_shapes(cuda, case):
    """The tensor-core backward at the frontend archs' training shapes
    (``chip_smoke.FRONTEND_BWD``): non-causal with Sq = Skv and Sq < Skv (a
    ragged 1500-key walk, G = 1), causal at G = 1 and G = 7.  The training
    forward equal to the serving call, within ``BF16_ULPS`` bf16 ulps of
    the plain forward run in f32 on the same bf16 inputs and its
    log-sum-exp within 2e-5 of that one's; dq, dk and dv against the plain
    backward run in f32, within ``BF16_BWD_ULPS`` bf16 ulps of each output
    row's largest value, floored at 2^-8 of the tensor's largest (the
    kernel rounds only its stored gradients: 0.5 ulps in
    ``scripts/torch_flash_bwd_bar.py``'s CPU model; P and dS as one bf16
    term each read 1.2-1.6, a dK / dV walk that skips its last query tile
    over 200); the same bits twice, on the tensor cores."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_train_cuda)

    B, Sq, Skv, causal, heads, _ = case
    q, k, v, do = cs.frontend_bwd_case(torch, B, Sq, Skv, heads["Hq"], heads["Hkv"], heads["hd"])
    out, lse = flash_attention_train_cuda(q, k, v, causal, None, 0)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal, None, 0))
    out_f32, lse_f32 = cs.fwd_exact(torch, q, k, v, causal)
    fwd_ulps = cs.bf16_row_ulps(torch, out, out_f32)
    assert fwd_ulps <= cs.BF16_ULPS, f"forward: {fwd_ulps:.2f} bf16 ulps"
    torch.testing.assert_close(lse, lse_f32, atol=cs.F32_KERNEL_TOL, rtol=0)
    del out_f32, lse_f32
    before = flash_attention_bwd_cuda.launches_by_path["mma"]
    args = (do, q, k, v, out, lse, causal, None, 0)
    got = flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches_by_path["mma"] == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    ulps, err = cs.bwd_row_ulps(torch, got, cs.bwd_exact(torch, args))
    assert ulps <= cs.BF16_BWD_ULPS, f"backward: {ulps:.2f} bf16 ulps ({err:.3e})"
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd_cuda(*args)))


def _mla_case(B, S, H=16, dqk=192, dv=128):
    """B3's bf16 inputs at latent attention's widths (moonlight-16b-a3b: 16
    heads, q / k of 128 + 64 rope dims, v of 128): q, k, v and dout, from a
    generator on the card seeded by the shape."""
    gen = torch.Generator(device="cuda").manual_seed(20 + S)
    q, k = (torch.randn((B, S, H, dqk), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    v, do = (torch.randn((B, S, H, dv), generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    return q, k, v, do


def _by_head(fn, *tensors):
    """``fn`` over one head at a time (q, k, v, out, dout [B, S, H, n] and lse
    [B, H, S] sliced alike; no head shares another's k or v here), its
    outputs joined along the heads: the f32 and f64 plain versions' score
    matrices at S = 8192 are ~0.5 GB a head."""
    parts = []
    for h in range(tensors[0].shape[2]):
        parts.append(fn(*(t[:, :, h:h + 1] if t.dim() == 4 else t[:, h:h + 1] for t in tensors)))
    return tuple(torch.cat([p[i] for p in parts], dim=2 if parts[0][i].dim() == 4 else 1)
                 for i in range(len(parts[0])))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(2, 512), (1, 8192)])
def test_flash_kernels_at_latent_attention_widths(cuda, B, S):
    """B3 and B3-bwd at latent attention's widths (q / k 192, v 128, 16 / 16
    heads, causal, bf16) on the tensor cores, at no padded width: the
    training forward equal to the serving call, within ``BF16_ULPS`` bf16
    ulps of the plain forward run in f32 on the same inputs (one head at a
    time) and its log-sum-exp within 2e-5 of that one's; dq, dk and dv
    within ``BF16_BWD_ULPS`` bf16 ulps of the plain backward run in f32
    (the bars of the frontend shapes); the same bits twice."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.flash_attention.ops import _plain_forward

    q, k, v, do = _mla_case(B, S)
    before = (flash_attention_train_cuda.launches_by_path["mma"],
              flash_attention_bwd_cuda.launches_by_path["mma"])
    out, lse = flash_attention_train_cuda(q, k, v, True, None, 0)
    assert out.shape == v.shape[:1] + q.shape[1:3] + v.shape[3:]
    assert torch.equal(out, flash_attention_cuda(q, k, v, True, None, 0))
    out_f32, lse_f32 = _by_head(
        lambda *t: _plain_forward(*(x.float() for x in t), True, None, 0, 1024, 512), q, k, v)
    fwd_ulps = cs.bf16_row_ulps(torch, out, out_f32)
    assert fwd_ulps <= cs.BF16_ULPS, f"forward: {fwd_ulps:.2f} bf16 ulps"
    torch.testing.assert_close(lse, lse_f32, atol=cs.F32_KERNEL_TOL, rtol=0)
    del out_f32, lse_f32
    args = (do, q, k, v, out, lse, True, None, 0)
    got = flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert (flash_attention_train_cuda.launches_by_path["mma"],
            flash_attention_bwd_cuda.launches_by_path["mma"]) == (before[0] + 1, before[1] + 1)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert all(torch.isfinite(g).all() for g in got)

    def exact(d, q_, k_, v_, o_, lse_):
        return flash_attention_bwd_plain(*(t.float() for t in (d, q_, k_, v_, o_)), lse_,
                                         True, None, 0)

    ulps, err = cs.bwd_row_ulps(torch, got, _by_head(exact, do, q, k, v, out, lse))
    assert ulps <= cs.BF16_BWD_ULPS, f"backward: {ulps:.2f} bf16 ulps ({err:.3e})"
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd_cuda(*args)))


@pytest.mark.gpu
def test_embedding_gradient_sums_a_frequent_row_in_f32(cuda):
    """The training lookup's gradient (``transformer.embedding_grad``) at
    8,192 Zipf(1.1) ids over moonlight-16b-a3b's 163,840 rows: id 0's row
    (~1,080 occurrences) and every other row within one bf16 ulp of its
    largest value of the f32 sum, rows no id names zero; the same bits
    twice."""
    from repro_torch.models import transformer

    V, D, T = 163_840, 2048, 8192
    gen = torch.Generator(device="cuda").manual_seed(11)
    ranks = torch.arange(1, V + 1, dtype=torch.float64, device="cuda")
    ids = torch.multinomial((ranks ** -1.1).float(), T, replacement=True, generator=gen)
    grad = torch.randn((T, D), generator=gen, device="cuda").bfloat16()
    got = transformer.embedding_grad(ids, grad, V, torch.bfloat16)
    want = torch.zeros((V, D), device="cuda").index_add_(0, ids, grad.float())
    assert int((ids == 0).sum()) > 500
    rows = ids.unique()
    assert cs.bf16_row_ulps(torch, got[:1], want[:1]) <= 1
    assert cs.bf16_row_ulps(torch, got[rows], want[rows]) <= 1
    unnamed = torch.ones(V, dtype=torch.bool, device="cuda")
    unnamed[rows] = False
    assert not bool(got[unnamed].any())
    assert torch.equal(got, transformer.embedding_grad(ids, grad, V, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_frontend_smoke_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Loss and every gradient of a frontend arch's smoke config (f32,
    remat on, the batch with its frames or image rows) on the card against
    the CPU within 1e-4; B3's training forward and backward launches:
    whisper's encoder once, each decoder layer's self- and cross-attention
    twice forward, every backward once."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_train_cuda)
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.train.step import value_and_grad

    cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = model_api.make_batch(cfg, ShapeSpec("t", 32, 2, "train"),
                                 torch.Generator().manual_seed(2))
    vg = value_and_grad(lambda p, b: model_api.lm_loss(cfg, p, b, remat=True), has_aux=True)
    cpu = pytree.tree_leaves(vg(params, batch))
    before = flash_attention_train_cuda.launches, flash_attention_bwd_cuda.launches
    card = pytree.tree_leaves(vg(pytree.tree_map(lambda t: t.to(cuda), params),
                                 pytree.tree_map(lambda t: t.to(cuda), batch)))
    dec = cfg.n_layers * (2 if cfg.cross_attention else 1)
    assert (flash_attention_train_cuda.launches - before[0],
            flash_attention_bwd_cuda.launches - before[1]) == (
        2 * dec + cfg.n_encoder_layers, dec + cfg.n_encoder_layers)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_flash_training_op_gradients_on_the_card_match_the_cpu(cuda):
    from repro_torch.models.layers import chunked_attention

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 48, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32), (2, 48, 4, 32))]
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.as_tensor(a, device=dev).requires_grad_(True) for a in arrays[:3])
        out = chunked_attention(q, k, v, causal=True, window=20, chunk=16, q_chunk=16)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            out, (q, k, v), torch.as_tensor(arrays[3], device=dev))]
    for a, b in zip(grads["cpu"], grads[str(cuda)]):
        torch.testing.assert_close(b, a, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,H,gates,state", [(64, 1024, torch.float32, torch.float32),
                                             (64, 1024, torch.bfloat16, torch.float32),
                                             (37, 200, torch.float32, torch.float32),
                                             (5, 64, torch.bfloat16, torch.bfloat16)])
def test_lstm_cell_backward_kernel_matches_plain(cuda, N, H, gates, state):
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda, lstm_cell_bwd_plain

    rng = np.random.default_rng(N + H)
    gx, gh = (torch.as_tensor(rng.standard_normal((N, 4 * H)), dtype=gates, device=cuda)
              for _ in range(2))
    b = torch.as_tensor(rng.standard_normal(4 * H), dtype=gates, device=cuda)
    c, dc = (torch.as_tensor(rng.standard_normal((N, H)), dtype=state, device=cuda)
             for _ in range(2))
    dh = torch.as_tensor(rng.standard_normal((N, H)), dtype=gates, device=cuda)
    dg, dcp = lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc)
    rg, rc = lstm_cell_bwd_plain(gx, gh, b, c, dh, dc)
    tol = 2e-5 if gates == state == torch.float32 else 3e-2
    assert dg.dtype == gates and dcp.dtype == state
    torch.testing.assert_close(dg.float(), rg.float(), atol=tol, rtol=0)
    torch.testing.assert_close(dcp.float(), rc.float(), atol=tol, rtol=0)
    again = lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc)
    assert torch.equal(again[0], dg) and torch.equal(again[1], dcp)
    other = torch.float32 if gates == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="dh must be"):
        lstm_cell_bwd_cuda(gx, gh, b, c, dh.to(other), dc)


@pytest.mark.gpu
def test_stacked_lstm_gradient_launches_one_backward_per_diagonal(cuda):
    from repro_torch.core.wavefront import sequential_lstm, stacked_wavefront_lstm
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda

    L, T, B, H = 3, 5, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    stacked = {k: (torch.randn(s, generator=gen, device=cuda) * 0.1).requires_grad_(True)
               for k, s in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)), ("b", (L, 4 * H)))}
    xs = torch.randn((T, B, H), generator=gen, device=cuda)
    before = lstm_cell_bwd_cuda.launches
    g = torch.autograd.grad((stacked_wavefront_lstm(stacked, xs, L) ** 2).sum(),
                            list(stacked.values()))
    assert lstm_cell_bwd_cuda.launches - before == L + T - 1
    per_layer = [{k: v[l].detach().clone().requires_grad_(True) for k, v in stacked.items()}
                 for l in range(L)]
    gs = torch.autograd.grad((sequential_lstm(per_layer, xs) ** 2).sum(),
                             [lp[k] for lp in per_layer for k in stacked])
    for l in range(L):
        for j in range(3):
            torch.testing.assert_close(gs[3 * l + j], g[j][l], atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """Loss and every gradient of the smoke gemma-2b (f32) on the card
    against the CPU within 1e-4, and a train step's loss on both."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train.step import lm_loss_fn, value_and_grad

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :32].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    vg = value_and_grad(lm_loss_fn(cfg, remat=True))
    cpu = pytree.tree_leaves(vg(params, batch))
    card = pytree.tree_leaves(vg(pytree.tree_map(lambda t: t.to(cuda), params),
                                 pytree.tree_map(lambda t: t.to(cuda), batch)))
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=0)


# -- training of the MoE and recurrent families: B5's, B6's and B7's backward
# kernels and B3's at their widths ----------------------------------------------

# B3-bwd at recurrentgemma-2b's training shape (10 query heads over one KV
# head of 256, its 2048-token window: fully causal at 512) and granite-moe's
# (16 / 8 heads of 64), and G = 10 at a ragged length and in f32
_FAMILY_BWD_CASES = [(4, 512, 512, 10, 1, 256, True, 2048, 0, torch.bfloat16),
                     (4, 512, 512, 16, 8, 64, True, None, 0, torch.bfloat16),
                     (2, 97, 97, 10, 1, 256, True, 40, 0, torch.bfloat16),
                     (1, 33, 33, 10, 1, 16, True, None, 0, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _FAMILY_BWD_CASES)
def test_flash_backward_kernel_at_the_family_widths(cuda, case):
    test_flash_backward_kernel_matches_plain(cuda, case)


# (E, C, D, F, dtype): granite-moe's training products (C = 640), gate / up
# and down, its smoke shape in f32, ragged C on the tensor cores (once with
# sums long enough to wrap the 4-stage ring), a D the 16-byte copies cannot
# take (SIMT in bf16), one slot
_MOE_BWD_CASES = [(32, 640, 1024, 512, torch.bfloat16), (32, 640, 512, 1024, torch.bfloat16),
                  (8, 24, 64, 32, torch.float32), (3, 37, 200, 72, torch.bfloat16),
                  (3, 201, 136, 200, torch.bfloat16),
                  (3, 37, 100, 72, torch.bfloat16), (2, 1, 8, 16, torch.bfloat16),
                  (3, 37, 200, 72, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 640, 1024, 512), (3, 201, 136, 200)])
def test_moe_gmm_backward_is_one_kernel_per_call(cuda, shape):
    """The tensor-core form computes dX and dW in one launch of one
    device kernel (``torch.profiler``), and either half alone when the
    other output is not asked for (the C entry's null pointer)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda, ops

    E, C, D, F = shape
    rng = np.random.default_rng(C)
    x, dy = (torch.as_tensor(rng.standard_normal((E, C, n)), dtype=torch.bfloat16, device=cuda)
             for n in (D, F))
    w = torch.as_tensor(rng.standard_normal((E, D, F)) * D ** -0.5, dtype=torch.bfloat16,
                        device=cuda)
    moe_gmm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        moe_gmm_bwd_cuda(x, w, dy)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "wgmma" in kernels[0], kernels
    for half in (0, 1):
        out = torch.empty_like((x, w)[half])
        ptrs = (out.data_ptr(), None) if half == 0 else (None, out.data_ptr())
        err = ops._lib().moe_gmm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), *ptrs, 1, E, C,
                                     D, F, 1, int(ops.moe_gmm_bwd_dw_first(C, D, F)),
                                     torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(out, moe_gmm_bwd_cuda(x, w, dy)[half])


@pytest.mark.gpu
@pytest.mark.parametrize("case", _MOE_BWD_CASES)
def test_moe_gmm_backward_kernel_matches_plain(cuda, case):
    """dx and dw against ``moe_gmm_bwd_plain``, every element; the form the
    call takes and counts; the same bits twice.  Each gradient is held on a
    cotangent that gives it a standard deviation of 0.25 (dX: dy ~ 0.25
    N(0, 1) sqrt(D / F); dW: dy ~ 0.25 N(0, 1) / sqrt(C)), so the bf16
    tolerance stays above a one-ulp flip and below a dropped slice of
    the sum."""
    from repro_torch.kernels.moe_gmm import (moe_gmm_bwd_cuda, moe_gmm_bwd_path,
                                             moe_gmm_bwd_plain)

    E, C, D, F, dt = case
    rng = np.random.default_rng(E + C + D + F)
    x = torch.as_tensor(rng.standard_normal((E, C, D)), dtype=dt, device=cuda)
    w = torch.as_tensor(rng.standard_normal((E, D, F)) * D ** -0.5, dtype=dt, device=cuda)
    before = dict(moe_gmm_bwd_cuda.launches_by_path)
    for which, scale in ((0, 0.25 * (D / F) ** 0.5), (1, 0.25 * C ** -0.5)):
        dy = torch.as_tensor(rng.standard_normal((E, C, F)) * scale, dtype=dt, device=cuda)
        path = moe_gmm_bwd_path(x, w, dy)
        assert path == ("mma" if dt == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
                        else "simt")
        got = moe_gmm_bwd_cuda(x, w, dy)
        torch.cuda.synchronize()
        ref = moe_gmm_bwd_plain(x, w, dy)
        assert all(g.dtype == dt and torch.isfinite(g).all() for g in got)
        torch.testing.assert_close(got[which].float(), ref[which].float(), atol=TOL[dt],
                                   rtol=0)
        again = moe_gmm_bwd_cuda(x, w, dy)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert moe_gmm_bwd_cuda.launches_by_path == {p: n + 4 * (p == path)
                                                 for p, n in before.items()}


def _ssm_bwd_case(cuda, B, S, D, St, c_dtype, with_h0, seed=0):
    rng = np.random.default_rng(seed + S + D)
    f32 = torch.float32
    dt = rng.uniform(0.001, 0.1, (B, S, D, 1))
    a = torch.as_tensor(np.exp(-dt * np.arange(1, St + 1)), dtype=f32, device=cuda)
    b = torch.as_tensor(dt * rng.standard_normal((B, S, D, St)), dtype=f32, device=cuda)
    c = torch.as_tensor(rng.standard_normal((B, S, St)), dtype=c_dtype, device=cuda)
    h0 = (torch.as_tensor(rng.standard_normal((B, D, St)), dtype=f32, device=cuda)
          if with_h0 else None)
    dy = torch.as_tensor(rng.standard_normal((B, S, D)) * D ** -0.5, dtype=f32, device=cuda)
    dh_last = torch.as_tensor(rng.standard_normal((B, D, St)), dtype=f32, device=cuda)
    return a, b, c, h0, dy, dh_last


# (B, S, D, St, c dtype, h0): falcon-mamba's training shape, its smoke
# shape, ragged D and S with a state, St not a power of two (5, and 1: a
# CTA of 256 channels), St = 32, one step, chunk ends (31, 32, 33)
_SSM_BWD_CASES = [(4, 512, 8192, 16, torch.bfloat16, False), (2, 32, 128, 4, torch.float32, False),
                  (2, 37, 200, 16, torch.float32, True), (3, 9, 50, 5, torch.bfloat16, True),
                  (2, 1, 64, 16, torch.float32, True), (2, 31, 300, 1, torch.float32, True),
                  (2, 33, 70, 32, torch.bfloat16, True), (1, 333, 40, 16, torch.bfloat16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _SSM_BWD_CASES)
def test_ssm_scan_backward_kernel_matches_plain(cuda, case):
    """From the training forward's checkpoints: da, db and dh0 bit-equal
    to ``ssm_scan_bwd_plain`` (the same chain, rounded alike), dc (a sum
    over D in another order) within the tolerance of c's dtype; the same
    bits twice."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda, ssm_scan_bwd_plain,
                                              ssm_scan_train_cuda)

    B, S, D, St, c_dtype, with_h0 = case
    args = _ssm_bwd_case(cuda, B, S, D, St, c_dtype, with_h0)
    args = (*args, ssm_scan_train_cuda(*args[:4])[2])
    before = ssm_scan_bwd_cuda.launches
    got = ssm_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert ssm_scan_bwd_cuda.launches == before + 1
    ref = ssm_scan_bwd_plain(*args[:6])
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.isfinite(g).all()
        if i == 2:
            torch.testing.assert_close(g.float(), r.float(), atol=TOL[c_dtype], rtol=0)
        else:
            assert torch.equal(g, r)
    assert all(torch.equal(g, r) for g, r in zip(got, ssm_scan_bwd_cuda(*args)))


# (B, S, R, h0): recurrentgemma's training shape, its smoke shape, ragged R
# with a state, one step
_RGLRU_BWD_CASES = [(4, 512, 2560, False), (2, 32, 64, False), (2, 37, 200, True),
                    (8, 1, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _RGLRU_BWD_CASES)
def test_rglru_scan_backward_kernel_is_bit_equal_to_plain(cuda, case):
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda, rglru_scan_bwd_plain

    B, S, R, with_h0 = case
    rng = np.random.default_rng(S + R)
    f32 = torch.float32
    a = torch.as_tensor(rng.uniform(0.5, 0.999, (B, S, R)), dtype=f32, device=cuda)
    b = torch.as_tensor(rng.standard_normal((B, S, R)), dtype=f32, device=cuda)
    h0 = torch.as_tensor(rng.standard_normal((B, R)), dtype=f32, device=cuda) if with_h0 else None
    hs, _ = rglru_scan_cuda(a, b, h0)
    dhs = torch.as_tensor(rng.standard_normal((B, S, R)), dtype=f32, device=cuda)
    dh_last = torch.as_tensor(rng.standard_normal((B, R)), dtype=f32, device=cuda)
    args = (a, hs, h0, dhs, dh_last)
    got = rglru_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, rglru_scan_bwd_plain(*args)))
    assert all(torch.equal(g, r) for g, r in zip(got, rglru_scan_bwd_cuda(*args)))


@pytest.mark.gpu
def test_backward_kernels_reject_what_they_cannot_take(cuda):
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda

    x, w = torch.zeros((2, 4, 8), device=cuda), torch.zeros((2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="dy must be"):
        moe_gmm_bwd_cuda(x, w, torch.zeros((2, 4, 8), device=cuda))
    with pytest.raises(TypeError, match="dy is"):
        moe_gmm_bwd_cuda(x, w, torch.zeros((2, 4, 16), device=cuda, dtype=torch.bfloat16))
    a = torch.zeros((1, 3, 5, 4), device=cuda)
    c = torch.zeros((1, 3, 4), device=cuda)
    ck = torch.zeros((1, 1, 5, 4), device=cuda)
    with pytest.raises(ValueError, match="dy must be"):
        ssm_scan_bwd_cuda(a, a, c, None, torch.zeros((1, 3, 4), device=cuda),
                          torch.zeros((1, 5, 4), device=cuda), ck)
    with pytest.raises(ValueError, match="h_ckpt must be"):
        ssm_scan_bwd_cuda(a, a, c, None, torch.zeros((1, 3, 5), device=cuda),
                          torch.zeros((1, 5, 4), device=cuda), ck[:, :, :4])
    with pytest.raises(ValueError, match="1 <= St <= 32"):
        big = torch.zeros((1, 3, 5, 33), device=cuda)
        ssm_scan_bwd_cuda(big, big, torch.zeros((1, 3, 33), device=cuda), None,
                          torch.zeros((1, 3, 5), device=cuda), torch.zeros((1, 5, 33), device=cuda),
                          torch.zeros((1, 1, 5, 33), device=cuda))
    r = torch.zeros((1, 3, 5), device=cuda)
    with pytest.raises(ValueError, match="dh_last"):
        rglru_scan_bwd_cuda(r, r, None, r, torch.zeros((1, 4), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        rglru_scan_bwd_cuda(r, r, None, r.double(), torch.zeros((1, 5), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_family_smoke_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Loss, MoE aux and every gradient of a family's smoke config (f32,
    remat on) on the card against the CPU within 1e-4; the card's launches
    of the family's kernel (B6's training form for falcon-mamba): forward
    twice and backward once a layer."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_train_cuda
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.train.step import value_and_grad

    cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    fwd, bwd, kind, per_layer = {
        "granite-moe-1b-a400m": (moe_gmm_cuda, moe_gmm_bwd_cuda, "attn", 3),
        "falcon-mamba-7b": (ssm_scan_train_cuda, ssm_scan_bwd_cuda, "ssm", 1),
        "recurrentgemma-2b": (rglru_scan_cuda, rglru_scan_bwd_cuda, "rglru", 1)}[arch]
    n = per_layer * cfg.layer_kinds().count(kind)
    params = transformer.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :32].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    vg = value_and_grad(lambda p, b: model_api.lm_loss(cfg, p, b, remat=True), has_aux=True)
    cpu = pytree.tree_leaves(vg(params, batch))
    before = fwd.launches, bwd.launches
    card = pytree.tree_leaves(vg(pytree.tree_map(lambda t: t.to(cuda), params),
                                 pytree.tree_map(lambda t: t.to(cuda), batch)))
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (2 * n, n)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=0)


# -- the zoo's parallel block and the serving bench twins ------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_parallel_block_decode_step_three_ways(cuda, paged):
    """command-r-plus-104b's smoke decode step in f32 (attention and FFN
    side by side on one normed input) captured on the card: no path joins a
    layer's two branches, and the static plan, the dynamic scheduler and
    sequential ``Graph.execute`` give the same bits (chip_smoke.py checks
    the bf16 step at full width, with cuBLAS's per-stream workspaces
    fixed)."""
    dtype = torch.float32
    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step, make_paged_decode_step
    from torch_graph_paths import descendants, parallel_branches

    cfg = get_config("command-r-plus-104b", smoke=True).reduced(dtype=dtype, n_layers=4)
    params = transformer.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.tensor([[3], [7], [0]], dtype=torch.int32, device=cuda)
    if paged:
        cache = transformer.init_paged_cache(cfg, 3, 64, n_pages=24, page_size=8, device=cuda)
        table = torch.full((3, 8), -1, dtype=torch.int32)
        table[0, :2], table[1, :1] = torch.tensor([5, 9]), torch.tensor([2])
        cache = {"len": torch.tensor([10, 3, 0], dtype=torch.int32, device=cuda),
                 "table": table.to(cuda), "pages": cache["pages"]}
        for pg in cache["pages"]:
            pg["k"].normal_(generator=gen)
            pg["v"].normal_(generator=gen)
        step = make_paged_decode_step(cfg, 8)
    else:
        cache = transformer.init_cache(cfg, 3, 64, per_slot=True, device=cuda)
        for lc in cache["layers"]:
            lc["k"].normal_(generator=gen)
            lc["v"].normal_(generator=gen)
            lc["pos"][0, :10] = torch.arange(10, device=cuda)
            lc["pos"][1, :3] = torch.arange(3, device=cuda)
        cache["len"] = torch.tensor([10, 3, 0], dtype=torch.int32, device=cuda)
        step = make_decode_step(cfg)
    with Runtime(n_workers=3, device=cuda) as rt:
        exe = rt_compile(step, params, cache, tokens, runtime=rt, jit_nodes=True,
                         n_executors=3, team_size=1)
        for wo, down in parallel_branches(exe.captured, params):
            assert down not in descendants(exe.graph, wo)
            assert wo not in descendants(exe.graph, down)
        inputs = exe.captured.bind((params, cache, tokens))
        ref = exe.captured.unflatten(exe.graph.execute(inputs))
        assert torch.isfinite(ref[0]).all()
        for mode in ("static", "dynamic"):
            got = exe.captured.unflatten(exe.execute_host(inputs, host_mode=mode).outputs)
            assert torch.equal(got[0], ref[0])


def _twin(rel: str):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("twin,argv", [
    ("scripts/torch_bench_serve.py",
     ["--requests", "8", "--max-new", "6", "--prompt-lens", "4,12,20", "--arrival-rate", "0"]),
    ("scripts/torch_bench_serve_paged.py",
     ["--requests", "8", "--max-new", "3", "--legs", "1", "--system-len", "64",
      "--page-size", "8", "--prefill-chunk", "8", "--d-model", "64"]),
    ("scripts/torch_bench_sched_overhead.py",
     ["--repeats", "5", "--steps", "3", "--executors", "2"])])
def test_bench_twins_on_the_card(cuda, tmp_path, twin, argv):
    """Each serving bench twin at smoke size on the card: it names the card
    in its payload and every gate that is not a timing holds (token parity
    across engines, prefix sharing, the paged memory bound, the oracle
    checks, the schedule search)."""
    mod = _twin(twin)
    args = mod.parser().parse_args([*argv, "--out", str(tmp_path / "b.json")])
    res = mod.run(args)
    payload, gates = (res[0], mod.gates(*res)) if isinstance(res, tuple) else (res,
                                                                              mod.gates(res))
    assert payload["device"]["type"] == "cuda"
    assert payload["device"]["name"] == torch.cuda.get_device_name(0)
    checks = [(kind, msg) for kind, holds, msg in gates if kind != "speed" and not holds]
    assert not checks, checks


# -- the hazard checks and the hwperf layer on the card ------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m", "h2o-danube3-4b",
                                  "falcon-mamba-7b", "whisper-medium"])
def test_zoo_checks_capture_on_the_card(cuda, arch):
    """``python -m repro_torch.checks --zoo``'s sweep of one arch with its
    graphs captured over CUDA tensors: clean, nothing skipped, the paged
    pair certified where the arch serves paged."""
    from repro_torch.checks.cli import run_zoo_arch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    rep = run_zoo_arch(arch, device="cuda")
    assert rep.ok and "Z-SKIP" not in rep.by_rule(), rep.render()
    if transformer.paged_supported(get_config(arch, smoke=True)):
        assert "C-RO" in rep.by_rule() and "H-XOK" in rep.by_rule()


@pytest.mark.gpu
def test_checks_entry_point_on_the_card(cuda):
    from repro_torch.checks.cli import main

    assert main(["--no-asserts"]) == 0          # the FIFO probe on the card's streams


@pytest.mark.gpu
@pytest.mark.parametrize("launch", ["graph", "eager"])
def test_interference_harness_on_the_card(cuda, launch):
    """The co-location harness on two streams, each fed by its own host
    thread, each window one graph launch or one call a kernel: every class
    and pair measured, named by the card."""
    from repro_torch import hwperf

    m = hwperf.measure_interference(iters=20, repeats=1, device="cuda", launch=launch)
    assert m.device == torch.cuda.get_device_name(0) and m.launch == launch
    assert set(m.solo_host) == set(m.solo) and all(v > 0 for v in m.solo_host.values())
    assert set(m.classes()) == {"gemm", "elementwise", "memory"} and len(m.pair) == 9
    assert all(v > 0 for v in m.solo.values())
    assert all(m.slowdown(a, b) >= 1.0 for a in m.classes() for b in m.classes())
    model = hwperf.ContentionModel.from_matrix(m)
    assert hwperf.ContentionModel.from_dict(model.to_dict()).to_dict() == model.to_dict()


@pytest.mark.gpu
def test_runtime_pins_the_stream_threads_or_reports_the_os(cuda):
    """Runtime(pinning="on") on the card: each stream's launcher thread on
    its planned cores, or, where the OS refuses, one warning and an
    unpinned pool, never a silent pass."""
    import os
    import warnings

    from repro_torch.runtime import Runtime

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with Runtime(device="cuda", pinning="on") as rt:
            tids = rt.pool.executor_thread_ids()
            applied = rt.pinning_applied
            assert applied is not None and len(tids) == rt.n_workers
            if applied.pinned:
                for ex, tid in enumerate(tids):
                    assert os.sched_getaffinity(tid) == set(applied.plan.cpus_for(ex))
            else:
                assert applied.errors or not hasattr(os, "sched_setaffinity")
                assert len([w for w in caught if issubclass(w.category, RuntimeWarning)]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_fleet_replicas_on_the_card(cuda, kind):
    """Two replicas of the smoke gemma-2b (f32, untied head) on the card,
    each a spawned process with its own CUDA context, through a kill once
    every request has streamed a token: nothing lost, the respawn reaches
    ready, and every stream not failed over equals an in-process engine's
    greedy stream bit for bit."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.fleet import FaultInjector, FaultSpec, Fleet, FleetConfig
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
    from repro_torch.serve.paged import PagedConfig, PagedEngine

    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 512, size=n)] for n in (8, 19, 11, 19)]
    spec = {"kind": kind, "arch": "gemma-2b", "smoke": True, "device": "cuda",
            "overrides": {"dtype": "float32", "tie_embeddings": False},
            "max_batch": 2, "max_len": 26}
    cfg_f = FleetConfig(n_workers=2, engine=spec, heartbeat_s=0.5, liveness_s=120.0,
                        startup_grace_s=300.0, max_inflight_per_worker=2, term_grace_s=2.0)
    with Fleet(cfg_f) as fleet:
        rids = [fleet.submit(p, 6) for p in prompts]
        deadline = time.monotonic() + 300
        while not all(fleet._requests[rid].tokens for rid in rids):
            assert time.monotonic() < deadline, "no first tokens in time"
            fleet.pump()
        inj = FaultInjector([FaultSpec(kind="kill", at_tokens=0)], seed=0)
        inj.tick(fleet)
        done = fleet.run(timeout_s=300)
        fleet.wait_ready(timeout_s=300)
        stats = fleet.stats()
    assert len(done) == 4 and all(len(r.tokens) == 6 for r in done)
    assert stats["n_failovers"] == 1 and stats["n_restarts"] == 1 and stats["n_requeued"] >= 1

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32, tie_embeddings=False)
    params = transformer.init_params(cfg, 0, device="cuda")
    scfg = ServeConfig(max_batch=2, max_len=26, temperature=0.0)
    rt = Runtime(device="cuda")
    try:
        eng = (PagedEngine(cfg, params, scfg, paged=PagedConfig(), device="cuda", runtime=rt)
               if kind == "paged" else ContinuousEngine(cfg, params, scfg, device="cuda",
                                                        runtime=rt))
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt=np.asarray(p, np.int32), max_new_tokens=6))
        want = {r.request_id: list(r.output) for r in eng.run()}
    finally:
        rt.close()
    for r in done:
        if not r.n_requeues:
            assert list(r.tokens) == want[r.rid], r.rid


# ---------------------------------------------------------------------------
# the distribution layer on the card: B2's log-sum-exp form, a world-1 NCCL
# group's sharded step, one rank's share of a production mesh
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["shared", "per_row"])
def test_decode_lse_form_matches_plain(cuda, dtype, form):
    """Output and log-sum-exp of every row against the plain version; a
    row keeping nothing (per row: the last) is -inf in both, its output the
    mean of V; one launch counted in ``launches_by_form["lse"]``."""
    B, Hq, Hkv, hd, C = 4, 8, 1, 256, 512
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, Hq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, C, Hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, C, Hkv, hd), generator=g, device="cuda").to(dtype)
    if form == "shared":
        kv_pos = torch.arange(C, dtype=torch.int32, device="cuda")
        q_pos = torch.tensor(C - 1, dtype=torch.int32, device="cuda")
    else:
        lengths = (C, 200, 7, 0)
        kv_pos = torch.full((B, C), -1, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
        kv_pos, q_pos = kv_pos.cuda(), q_pos.cuda()
    before = decode_attention_cuda.launches_by_form.get("lse", 0)
    out, lse = decode_attention_cuda(q, k, v, kv_pos, q_pos, None, lse=True)
    assert decode_attention_cuda.launches_by_form["lse"] == before + 1
    ref, ref_lse = decode_attention_plain(q, k, v, kv_pos, q_pos, None, lse=True)
    tol = TOL[dtype]
    assert float((out.float() - ref.float()).abs().max()) <= tol
    idle = torch.isneginf(ref_lse)
    assert torch.equal(idle, torch.isneginf(lse))
    assert bool(idle.any()) == (form == "per_row")
    assert float((lse[~idle] - ref_lse[~idle]).abs().max()) <= 4 * tol


@pytest.mark.gpu
def test_world1_nccl_sharded_step_equals_unsharded(cuda, monkeypatch):
    """A real NCCL group of one and a 1x1 mesh: two of the smoke gemma's
    sharded steps give the unsharded steps' losses and gradient norms, bit
    for bit, both through AdamW's multi-tensor kernels (the DTensor leaves
    as their local shards, 3 launches a step); the per-leaf loop gives the
    losses and norms within 1e-6 of them."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Mesh, state_pspecs
    from repro_torch.dist.train import distribute_tree, init_group, make_sharded_train_step
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step

    cfg = get_config("gemma-2b", smoke=True)
    tcfg = TrainStepConfig(remat=True)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def two_steps(step, state):
        out = []
        for _ in range(2):
            before = adamw_ops.global_norm_cuda.launches + adamw_ops.adamw_update_cuda.launches
            state, metrics = step(state, batch)
            out.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
            out[-1]["launches"] = (adamw_ops.global_norm_cuda.launches
                                   + adamw_ops.adamw_update_cuda.launches - before)
        return out

    want = two_steps(make_train_step(cfg, tcfg), init_train_state(cfg, 0, device="cuda"))
    with monkeypatch.context() as m:
        m.setattr(adamw_ops, "refusal", lambda *a: "the loop, for the comparison")
        loop = two_steps(make_train_step(cfg, tcfg), init_train_state(cfg, 0, device="cuda"))
    init_group("cuda")
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        dm = mesh.to_device_mesh("cuda")
        state = init_train_state(cfg, 0, device="cuda")
        state = distribute_tree(state, state_pspecs(cfg, state, mesh), mesh, dm)
        got = two_steps(make_sharded_train_step(cfg, tcfg, mesh, dm, global_batch=2), state)
    finally:
        dist.destroy_process_group()
    assert got == want and [w["launches"] for w in want] == [3, 3]
    for w, lp in zip(want, loop):
        assert lp["launches"] == 0
        for key in ("loss", "grad_norm"):
            assert abs(w[key] / lp[key] - 1) <= 1e-6, key


@pytest.mark.gpu
def test_fake_backend_rank_share_runs(cuda):
    """Rank 0's share of the single-pod mesh under the fake process group
    (the smoke gemma's decode_32k cell): traced, then run on the card with
    B2's log-sum-exp form once a layer."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    rec = dryrun.run_cell("gemma-2b", "decode_32k", make_production_mesh(), smoke=True,
                          want_graphi=False, run=True, device="cuda")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["run"]["fits_hbm_measured"]
    assert rec["run"]["launches"]["decode_attention.lse"] == 2
    assert rec["roofline"]["flops"] > 0


# ---------------------------------------------------------------------------
# the multi-tensor AdamW kernels (kernels/adamw) against the per-leaf loop
# ---------------------------------------------------------------------------

def _bits(t):
    """A tensor's bits, to compare exactly (NaN and -0 included)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _kernel_norm(grads, clip):
    """The kernels' global norm and clip scale of ``grads`` alone."""
    from repro_torch.kernels.adamw import ops as adamw_ops

    g = torch.utils._pytree.tree_leaves(grads)
    chunks, splits = adamw_ops.device_plan(tuple(x.numel() for x in g), g[0].device)
    tables = adamw_ops.leaf_tables(g, g, g, g, [False] * len(g), splits)
    return adamw_ops.global_norm_cuda(tables, chunks, splits, clip)


def _adamw_twins(params, clip, steps=3, seed=0):
    """``steps`` AdamW steps of ``params`` through the kernels and of a copy
    through the per-leaf loop, the kernels' clip scale replaced by the
    loop's; the same gradients (each in its parameter's dtype).  Returns
    ``(params, state)`` of the loop and of the kernels and, a step, the
    loop's metrics with the kernels' own norm and scale taken twice."""
    from unittest import mock

    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim import adamw as opt

    tree_map = torch.utils._pytree.tree_map
    loop_p = tree_map(torch.clone, params)
    loop_st, fused_st = opt.adamw_init(loop_p), opt.adamw_init(params)
    cfg = opt.AdamWConfig(lr=1e-3, clip_norm=clip)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    steps_out = []
    for i in range(steps):
        grads = tree_map(lambda p: (torch.randn(p.shape, generator=gen, device="cuda")
                                    * 0.02).to(p.dtype), params)
        lr = torch.tensor(1e-3 * (i + 1), device="cuda")
        with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop"):
            loop_p, loop_st, ml = opt.adamw_update(grads, loop_p, loop_st, cfg, lr=lr)
        own = [_kernel_norm(grads, clip), _kernel_norm(grads, clip)]
        before = adamw_ops.adamw_update_cuda.launches
        with mock.patch.object(adamw_ops, "global_norm_cuda",
                               lambda *a: (ml["grad_norm"], ml["clip_scale"])):
            params, fused_st, mf = opt.adamw_update(grads, params, fused_st, cfg, lr=lr)
        n = len(torch.utils._pytree.tree_leaves(params))
        assert adamw_ops.adamw_update_cuda.launches == before + -(-n // adamw_ops.MAX_LEAVES)
        assert mf["clip_scale"] is ml["clip_scale"]
        steps_out.append((ml, own))
    torch.cuda.synchronize()
    return (loop_p, loop_st), (params, fused_st), steps_out


def _h2o_leaves():
    """h2o-danube3-4b's leaves at full width, one layer (~400 M parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    return init_params(get_config("h2o-danube3-4b").reduced(n_layers=1), 0, device="cuda")


def _granite_leaves():
    """granite-moe-1b-a400m's leaves at full width, two layers: bf16 leaves
    and the f32 routers."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    return init_params(get_config("granite-moe-1b-a400m").reduced(n_layers=2), 0, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1.0, 1e9])
@pytest.mark.parametrize("leaves", [_h2o_leaves, _granite_leaves], ids=["h2o", "granite"])
def test_adamw_kernels_equal_the_loop_bit_for_bit(cuda, leaves, clip):
    """Three steps on an h2o-shaped and a granite-shaped leaf set (its f32
    routers included), the clip active (1.0) and not: given the loop's
    scale the kernels' p, m and v are the loop's bit for bit; their own
    norm is within 1e-6 of ``global_norm``'s, and the same bits twice."""
    params = leaves()
    dtypes = {p.dtype for p in torch.utils._pytree.tree_leaves(params)}
    assert torch.bfloat16 in dtypes and (leaves is _h2o_leaves or torch.float32 in dtypes)
    (p_loop, s_loop), (p_fused, s_fused), steps = _adamw_twins(params, clip)
    for x, y in zip(torch.utils._pytree.tree_leaves((p_loop, s_loop["m"], s_loop["v"])),
                    torch.utils._pytree.tree_leaves((p_fused, s_fused["m"], s_fused["v"]))):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    for ml, ((n1, s1), (n2, s2)) in steps:
        assert torch.equal(_bits(n1), _bits(n2)) and torch.equal(_bits(s1), _bits(s2))
        assert abs(float(n1) / float(ml["grad_norm"]) - 1) <= 1e-6
        assert abs(float(s1) / float(ml["clip_scale"]) - 1) <= 1e-6
        assert (float(ml["clip_scale"]) < 1) == (clip == 1.0)


@pytest.mark.gpu
def test_adamw_kernels_take_unaligned_views_and_small_leaves(cuda):
    """Views at odd offsets of one buffer (no 16-byte alignment), a
    1-element leaf, ragged sizes, fp16 and f32 parameters and bf16 ones
    with f32 gradients, and 700 leaves (two launches' tables): every leaf
    takes the kernels, and given the loop's scale they give its bits."""
    from repro_torch.kernels.adamw import ops as adamw_ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn(3 * adamw_ops.CHUNK + 64, generator=gen, device="cuda").to(torch.bfloat16)
    params = {"w_odd": buf[1:1 + adamw_ops.CHUNK + 7].view(adamw_ops.CHUNK + 7, 1),
              "w_odd2": buf[adamw_ops.CHUNK + 13:2 * adamw_ops.CHUNK + 30],
              "b": torch.randn(1, generator=gen, device="cuda"),
              "ln1": torch.randn(9, generator=gen, device="cuda").half(),
              "small": [torch.randn(3 + i % 5, generator=gen, device="cuda").to(torch.bfloat16)
                        for i in range(700)]}
    leaves = torch.utils._pytree.tree_leaves(params)
    ptrs = [p.data_ptr() for p in leaves]
    assert len(leaves) > adamw_ops.MAX_LEAVES and ptrs[0] % 16 and ptrs[1] % 16
    grads_like = [torch.zeros_like(p) for p in leaves]
    state = [torch.zeros(p.shape, device="cuda") for p in leaves]
    assert adamw_ops.refusal(leaves, grads_like, state, state) is None
    (p_loop, s_loop), (p_fused, s_fused), steps = _adamw_twins(params, 1.0)
    assert [p.data_ptr() for p in torch.utils._pytree.tree_leaves(p_fused)] == ptrs
    for x, y in zip(torch.utils._pytree.tree_leaves((p_loop, s_loop["m"], s_loop["v"])),
                    torch.utils._pytree.tree_leaves((p_fused, s_fused["m"], s_fused["v"]))):
        assert torch.equal(_bits(x), _bits(y))
    # a bf16 parameter with an f32 gradient (microbatched training's accumulator)
    from repro_torch.optim import adamw as opt

    p = buf[3:3 + 1001].clone()
    twin = p.clone()
    g = torch.randn(1001, generator=gen, device="cuda")
    sa, sb = opt.adamw_init({"w": p}), opt.adamw_init({"w": twin})
    from unittest import mock

    with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop"):
        _, _, ml = opt.adamw_update({"w": g}, {"w": p}, sa)
    with mock.patch.object(adamw_ops, "global_norm_cuda",
                           lambda *a: (ml["grad_norm"], ml["clip_scale"])):
        opt.adamw_update({"w": g}, {"w": twin}, sb)
    assert torch.equal(_bits(p), _bits(twin)) and torch.equal(sa["v"]["w"], sb["v"]["w"])


@pytest.mark.gpu
def test_adamw_kernels_take_a_transposed_gradient_and_raise_on_bf16_moments(cuda):
    """On the card every tree takes the kernels or raises: a transposed
    (non-contiguous) gradient and an fp16 gradient of an f32 parameter are
    copied as the loop reads them (its bits given the loop's scale); bf16
    moments, which the kernels do not hold, raise rather than fall back to
    the loop."""
    from unittest import mock

    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim import adamw as opt

    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {"w": torch.randn(96, 40, generator=gen, device="cuda").to(torch.bfloat16),
              "b": torch.randn(40, generator=gen, device="cuda")}
    grads = {"w": torch.randn(40, 96, generator=gen, device="cuda").to(torch.bfloat16).t(),
             "b": torch.randn(40, generator=gen, device="cuda").half()}
    twin = {k: v.clone() for k, v in params.items()}
    sa, sb = opt.adamw_init(params), opt.adamw_init(twin)
    with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop"):
        _, _, ml = opt.adamw_update(grads, twin, sb)
    before = adamw_ops.adamw_update_cuda.launches
    with mock.patch.object(adamw_ops, "global_norm_cuda",
                           lambda *a: (ml["grad_norm"], ml["clip_scale"])):
        opt.adamw_update(grads, params, sa)
    assert adamw_ops.adamw_update_cuda.launches == before + 1
    for k in params:
        for x, y in ((params[k], twin[k]), (sa["m"][k], sb["m"][k]), (sa["v"][k], sb["v"][k])):
            assert torch.equal(_bits(x), _bits(y)), k
    bad = opt.adamw_init(params, opt.AdamWConfig(moment_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="moments f32"):
        opt.adamw_update(grads, params, bad)


# ---------------------------------------------------------------------------
# MoE routing's slot assignment (repro_torch::moe_route_slots)
# ---------------------------------------------------------------------------

def _route_equal(cuda, idx, E, C):
    """The kernel against the plain version on the same ids, one launch a
    call: every position, keep flag, count and slot bit for bit, the trash
    column a dropped token; the same bits on a second call."""
    idx = idx.to(cuda)
    before = route_slots_cuda.launches
    got = route_slots(idx, E, C)
    torch.cuda.synchronize()
    assert route_slots_cuda.launches == before + 1
    positions, keep, slot_tok, counts = got
    G, Tg, k = idx.shape
    assert [tuple(t.shape) for t in got] == [(G, Tg, k), (G, Tg, k), (G, E, C + 1), (G, E)]
    assert [t.dtype for t in got] == [torch.int64, torch.bool, torch.int64, torch.int64]
    want = route_slots_plain(idx, E, C)
    for a, b in zip((positions, keep, slot_tok[..., :C], counts),
                    (want[0], want[1], want[2][..., :C], want[3])):
        assert torch.equal(a, b)
    assert_trash(slot_tok, idx, keep, counts, C)
    again = route_slots(idx, E, C)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert route_slots_cuda.launches == before + 2
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("G,Tg,k,E,C,how", SLOT_CASES, ids=SLOT_IDS)
def test_route_slots_kernel_matches_plain(cuda, G, Tg, k, E, C, how):
    _, keep, _, _ = _route_equal(cuda, slot_ids(G, Tg, k, E, how, seed=Tg + k), E, C)
    if how != "distinct" or C * E < k * Tg:
        assert not bool(keep.all())            # these cases drop claims


@pytest.mark.gpu
@pytest.mark.parametrize("Tg,k,E,C", [(512, 8, MAX_EXPERTS, 8), (70000, 2, 8, 20000),
                                      (1, 1, 1, 0)])
def test_route_slots_kernel_at_its_limits(cuda, Tg, k, E, C):
    """The widest router the kernel takes (its most shared memory); more
    claims than 16 rounds of 32 tiles (rounds at their most, more tiles);
    one claim and no slot (it goes to the trash)."""
    _route_equal(cuda, slot_ids(1, Tg, k, E, "skewed", seed=E), E, C)


@pytest.mark.gpu
def test_route_slots_kernel_never_falls_back(cuda, monkeypatch):
    from repro_torch.kernels.moe_route import ops

    def plain(*a):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(ops, "route_slots_plain", plain)
    idx = slot_ids(1, 64, 8, 32, "distinct", seed=0).to(cuda)
    before = route_slots_cuda.launches
    route_slots(idx, 32, 16)
    assert route_slots_cuda.launches == before + 1
    with pytest.raises(ValueError, match="at most"):
        route_slots(idx.clamp(max=MAX_EXPERTS), MAX_EXPERTS + 1, 16)
    with pytest.raises(TypeError, match="int64"):
        route_slots(idx.int(), 32, 16)
    empty = route_slots(idx[:, :0], 32, 16)
    assert route_slots_cuda.launches == before + 1
    assert not empty[2].any() and not empty[3].any()
