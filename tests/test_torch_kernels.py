"""Paged decode attention: the port's plain version against the JAX
package's jnp path and its Pallas kernel (interpret mode).  The CUDA kernel
is held against the plain version on the card in ``test_torch_gpu.py``.

Inputs come from numpy with a fixed seed and cover mixed lengths, a row
whose pages are shared with another row, an idle row (no mapped page,
compared nowhere: its output is discarded by the engine), and a sliding
window.  Tolerances as ``tests/test_kernels.py``: 2e-5 in f32, 3e-2 in
bf16 (the two frameworks round bf16 at different places).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import paged_decode_attention as j_paged
from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  paged_decode_attention_cuda,
                                                  paged_decode_attention_plain)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _case(dtype: str, B=5, Hq=4, Hkv=2, hd=16, ps=8, n_pt=4, seed=0):
    rng = np.random.default_rng(seed)
    P = B * n_pt
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    table = np.full((B, n_pt), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    lengths = [3, 17, 31, 11]               # positions 0..len-1 live
    pages = iter(rng.permutation(P))
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[b, j] = next(pages)
        q_pos[b] = n - 1
    table[3, :2] = table[2, :2]             # row 3 shares row 2's first two pages
    # row 4 stays idle: no mapped page, q_pos 0
    live = np.array(lengths + [0]) > 0
    cast = NP_DT[dtype]
    return (q.astype(cast), k.astype(cast), v.astype(cast), table, q_pos), live


def _torch(args, dtype):
    q, k, v, table, q_pos = args
    dt = TORCH_DT[dtype]
    return (torch.tensor(np.asarray(q, np.float32), dtype=dt),
            torch.tensor(np.asarray(k, np.float32), dtype=dt),
            torch.tensor(np.asarray(v, np.float32), dtype=dt),
            torch.as_tensor(table), torch.as_tensor(q_pos))


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_path", ["jnp", "pallas"])
def test_plain_matches_reference(ref_path, dtype, window):
    args, live = _case(dtype)
    kw = ({"use_kernel": False} if ref_path == "jnp"
          else {"use_kernel": True, "interpret": True})
    ref = np.asarray(j_paged(*(jnp.asarray(a) for a in args), window=window, **kw),
                     np.float32)
    out = paged_decode_attention_plain(*_torch(args, dtype), window=window)
    got = out.float().numpy()
    np.testing.assert_allclose(got[live], ref[live], atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("layout", ["model", "flat"])
def test_wrapper_layouts_and_custom_op(layout):
    args, live = _case("float32")
    q, k, v, table, q_pos = _torch(args, "float32")
    if layout == "model":
        out = paged_decode_attention(q[:, None], k, v, table, q_pos)[:, 0]
    else:
        out = torch.ops.repro_torch.paged_decode_attention(q, k, v, table, q_pos, None)
    ref = paged_decode_attention_plain(q, k, v, table, q_pos)
    assert torch.equal(out[torch.as_tensor(live)], ref[torch.as_tensor(live)])


def test_cpu_tensors_never_launch_the_kernel():
    args, _ = _case("float32")
    before = paged_decode_attention_cuda.launches
    paged_decode_attention(*_torch(args, "float32"))
    assert paged_decode_attention_cuda.launches == before
