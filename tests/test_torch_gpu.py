"""Tests that need a CUDA card: the hand-written kernels (B1 paged decode,
B2 dense decode, B3 flash attention, B4 LSTM cell, B5 grouped expert
matmul, B6 selective scan, B7 RG-LRU scan) against their plain versions,
and the executors on CUDA streams against the sequential oracle.

They import nothing of JAX, so the machine with the card runs them
(``python -m pytest -q -m gpu tests/test_torch_gpu.py``); here they skip.
Tolerances: 2e-5 in f32, 3e-2 in bf16 (the kernel keeps probabilities in
f32 where the plain version rounds them to bf16).
"""
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
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_cuda, rglru_scan_plain
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_cuda, ssm_scan_plain

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
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype, hd, case):
    """Every head width the main paths use (gemma and recurrentgemma 256,
    granite 64, olmoe 128) in both kernel forms: bf16 on the tensor cores,
    f32 on the CUDA cores."""
    Sq, Skv, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((2, Sq, 4, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, Skv, 2, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, Skv, 2, hd), generator=gen, device=cuda).to(dtype)
    before = flash_attention_cuda.launches
    path = flash_attention_path(dtype)
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
    q = torch.zeros((1, 8, 4, 48), device=cuda)
    with pytest.raises(ValueError):                 # hd 48 is not a compiled width
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
              (4, 512, 512, 8, 1, 256, True, 256, 0, torch.bfloat16)]


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
    path = flash_attention_bwd_path(dt)
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
