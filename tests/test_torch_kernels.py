"""Paged decode attention: the port's plain version against the JAX
package's jnp path and its Pallas kernel (interpret mode).  The CUDA kernel
is held against the plain version on the card in ``test_torch_gpu.py``.
Also the Python choice of a kernel's form (tensor cores or SIMT) for B3
and B5.

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
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 flash_attention_path)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_cuda, moe_gmm_path

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


# -- which form of a kernel a launch takes (chosen in Python, counted per form)

@pytest.mark.parametrize("dtype,path", [(torch.float32, "simt"), (torch.bfloat16, "mma"),
                                        (torch.float16, "mma")])
def test_flash_attention_path_follows_the_dtype(dtype, path):
    assert flash_attention_path(dtype) == path


@pytest.mark.parametrize("case,path", [
    ((2, 8, 64, 40, torch.bfloat16, 0), "mma"),     # decode slots
    ((2, 300, 1024, 512, torch.bfloat16, 0), "mma"),
    ((2, 8, 64, 40, torch.float32, 0), "simt"),     # TF32 would miss the f32 bar
    ((2, 8, 60, 40, torch.bfloat16, 0), "simt"),    # D not a multiple of 8
    ((2, 8, 64, 36, torch.bfloat16, 0), "simt"),    # F not a multiple of 8
    ((2, 8, 64, 40, torch.bfloat16, 1), "simt"),    # x 2 bytes off a 16-byte boundary
])
def test_moe_gmm_path_follows_dtype_shape_and_alignment(case, path):
    E, C, D, F, dtype, offset = case
    x = torch.zeros(E * C * D + offset, dtype=dtype)[offset:].view(E, C, D)
    w = torch.zeros((E, D, F), dtype=dtype)
    assert moe_gmm_path(x, w) == path


def test_cpu_tensors_count_no_kernel_form():
    before = (dict(flash_attention_cuda.launches_by_path), dict(moe_gmm_cuda.launches_by_path))
    q = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16)
    flash_attention(q, q, q)
    moe_gmm(torch.zeros((2, 3, 8), dtype=torch.bfloat16), torch.zeros((2, 8, 8),
                                                                      dtype=torch.bfloat16))
    assert (flash_attention_cuda.launches_by_path, moe_gmm_cuda.launches_by_path) == before
