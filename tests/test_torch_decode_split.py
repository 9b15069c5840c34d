"""The decode core's host side: the split it picks (CTAs per cluster and
entries per pipeline stage), the plain version at a head dimension the core
pads (h2o-danube3-4b's 120) against the JAX package, and the kernel build's
cache key.

The split is checked at the serving shapes of the configs the port runs
(gemma-2b dense and paged, granite-moe-1b-a400m, h2o-danube3-4b, the smoke
configs) and at f32 with hd 256, where two stages of 64 entries do not fit
shared memory.  The plain version is compared in f32 within 2e-5 and in
bf16 within 3e-2, the tolerances of ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode_kernel
from repro.models import layers as jl
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention_plain, decode_split
from repro_torch.kernels.decode_attention.ops import core_smem

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
SMEM = 232448          # shared memory an H100 CTA may opt in to
H100_SMS = 132

# (name, entries a row can hold, element bytes, hd, clusters = B * Hkv * ceil(G / 8))
SERVING = [
    ("gemma-2b dense, 1024 slots", 1024, 2, 256, 8),
    ("gemma-2b paged, 64 pages of 16", 64 * 16, 2, 256, 8),
    ("granite-moe-1b-a400m dense", 1024, 2, 64, 8 * 8),
    ("granite-moe-1b-a400m paged", 64 * 16, 2, 64, 8 * 8),
    ("h2o-danube3-4b dense", 1024, 2, 120, 8 * 8),
    ("recurrentgemma-2b local attention", 2048, 2, 256, 8 * 2),
    ("gemma-2b smoke, f32", 64, 4, 16, 3),
    ("granite smoke paged, f32", 8 * 8, 4, 16, 3 * 2),
    ("f32, hd 256", 1024, 4, 256, 8),
    ("one CTA's worth", 40, 4, 64, 4),
]


def _padded(hd: int) -> int:
    return next(h for h in (16, 32, 64, 128, 256) if hd <= h)


@pytest.mark.parametrize("name,n,itemsize,hd,clusters", SERVING, ids=[s[0] for s in SERVING])
def test_split_fits_and_gives_every_cta_work(name, n, itemsize, hd, clusters):
    n_c, chunk = decode_split(n, itemsize, hd, clusters, H100_SMS)
    assert 1 <= n_c <= 8
    assert chunk in (32, 64)
    assert core_smem(chunk, itemsize, _padded(hd)) <= SMEM
    # the CTAs split a row's range evenly: the last one starts inside the
    # largest row, so none idles there
    per = -(-n // n_c)
    assert (n_c - 1) * per < n
    # no more CTAs than two on each SM
    assert n_c * clusters <= 2 * H100_SMS or n_c == 1


def test_split_takes_the_largest_chunk_that_fits():
    assert decode_split(1024, 2, 256)[1] == 64
    assert decode_split(1024, 4, 256)[1] == 32     # 2 x (K, V) x 64 x 1040 B > 227 KB
    assert core_smem(64, 4, 256) > SMEM
    assert decode_split(1024, 2, 256, clusters=8)[0] == 8
    assert decode_split(1024, 2, 64, clusters=64)[0] == 4


@pytest.mark.parametrize("hd", [0, 257, 264])
def test_split_rejects_head_dims_the_core_lacks(hd):
    with pytest.raises(ValueError):
        decode_split(1024, 2, hd)


def _hd120_case(dtype, form, B=3, Hq=8, Hkv=2, hd=120, S=64, seed=7):
    """A ring buffer with two empty entries (shared) or rows at three depths,
    one of them wrapped (per row)."""
    rng = np.random.default_rng(seed)
    cast = NP_DT[dtype]
    q = rng.standard_normal((B, 1, Hq, hd)).astype(cast)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(cast)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(cast)
    if form == "shared":
        pos = np.arange(30, 30 + S, dtype=np.int32)
        kv_pos = np.full((S,), -1, np.int32)
        kv_pos[pos % S] = pos
        kv_pos[[5, 40]] = -1
        q_pos = np.int32(80)
    else:
        kv_pos = np.full((B, S), -1, np.int32)
        for b, n in enumerate([9, 64, 90]):
            p = np.arange(max(0, n - S), n, dtype=np.int32)
            kv_pos[b, p % S] = p
        q_pos = np.array([8, 63, 89], np.int32)
    return q, k, v, kv_pos, q_pos


def _torch(args, dtype):
    q, k, v, kv_pos, q_pos = args
    t = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=TORCH_DT[dtype])
    return t(q)[:, 0], t(k), t(v), torch.as_tensor(kv_pos), torch.as_tensor(q_pos)


@pytest.mark.parametrize("window", [None, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_hd_120_matches_the_tpu_kernel(dtype, window):
    """The shared form against the JAX package's Pallas kernel in interpret
    mode, which takes any head dimension."""
    args = _hd120_case(dtype, "shared")
    ref = j_decode_kernel(*(jnp.asarray(a) for a in args), window=window, block_k=16,
                          interpret=True)
    out = decode_attention_plain(*_torch(args, dtype), window)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32)[:, 0],
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_hd_120_matches_the_layer(dtype, window):
    """The per-row form against ``repro.models.layers.decode_attention``."""
    args = _hd120_case(dtype, "per_row")
    ref = jl.decode_attention(*(jnp.asarray(a) for a in args), window=window)
    out = decode_attention_plain(*_torch(args, dtype), window)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32)[:, 0],
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_build_target_changes_with_a_header(tmp_path, monkeypatch):
    """An edited header beside a kernel's source names a new library, so a
    stale one is never loaded."""
    src, hdr = tmp_path / "k.cu", tmp_path / "core.cuh"
    src.write_text('#include "core.cuh"\n')
    hdr.write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    monkeypatch.setitem(_build.SOURCES, "probe_kernel", src)
    first = _build._target("probe_kernel")
    (tmp_path / "notes.txt").write_text("edited\n")
    assert _build._target("probe_kernel") == first
    hdr.write_text("// v2\n")
    second = _build._target("probe_kernel")
    assert second != first and second.name.startswith("libprobe_kernel-")
    src.write_text('#include "core.cuh"\n// edited\n')
    assert _build._target("probe_kernel") not in (first, second)
