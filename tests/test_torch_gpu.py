"""Tests that need a CUDA card: the hand-written kernel against its plain
version, and the executors on CUDA streams against the sequential oracle.

They import nothing of JAX, so the machine with the card runs them
(``python -m pytest -q -m gpu tests/test_torch_gpu.py``); here they skip.
Tolerances: 2e-5 in f32, 3e-2 in bf16 (the kernel keeps probabilities in
f32 where the plain version rounds them to bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  paged_decode_attention_cuda,
                                                  paged_decode_attention_plain)

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
    m = live.to(cuda)
    torch.testing.assert_close(out[m].float(), ref[m].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.isfinite(out).all()


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
