"""B3's backward kernel, what the CPU can hold of it: the tensor-core form's
split of a key tile's query heads over a cluster (``flash_bwd_splits``,
plain Python; the C entry point takes its choice as an argument), the form
each dtype takes, and the checks
``flash_attention_bwd_cuda`` makes before it builds or launches anything.
The kernels themselves run only on the card (``tests/test_torch_gpu.py``)."""
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_path, flash_bwd_splits)
from repro_torch.kernels.flash_attention import ops

# (B, Sq, Skv, Hq, Hkv): gemma-2b training and prefill, granite, olmoe,
# recurrentgemma, one token, G = 3 and 6 (only 1 / 2 split them), long
SHAPES = [(4, 512, 512, 8, 1), (1, 512, 512, 8, 1), (2, 333, 333, 16, 8),
          (1, 512, 512, 16, 16), (1, 333, 333, 10, 1), (2, 1, 1, 8, 1), (3, 40, 100, 12, 4),
          (1, 97, 97, 6, 1), (1, 2048, 2048, 8, 1), (8, 64, 64, 8, 2), (2, 70, 50, 4, 2)]
SMS = [132, 114, 8]


def _splits(shape, sms=132):
    B, _, Skv, Hq, Hkv = shape
    return flash_bwd_splits(B, Skv, Hq, Hkv, sms=sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_splits_divide_the_query_heads_of_a_kv_head(shape, sms):
    Hq, Hkv = shape[3], shape[4]
    assert _splits(shape, sms) in (1, 2, 4, 8) and (Hq // Hkv) % _splits(shape, sms) == 0


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dkdv_grid_fills_the_sms_where_the_shape_allows(shape, sms):
    """The smallest split that fills the SMs; where none does, the most
    CTAs a split can give."""
    B, _, Skv, Hq, Hkv = shape
    splits = _splits(shape, sms)
    fits = [s for s in (1, 2, 4, 8) if (Hq // Hkv) % s == 0]
    base = -(-Skv // 64) * Hkv * B
    if base * fits[-1] >= sms:
        assert base * splits >= sms
        assert all(base * s < sms for s in fits if s < splits)
    else:
        assert splits == fits[-1]


@pytest.mark.parametrize("shape", SHAPES)
def test_splits_are_the_same_on_two_calls(shape):
    assert _splits(shape) == _splits(shape)


def test_gemma_training_shape_splits_its_eight_heads_eight_ways():
    """One KV head, 8 key tiles x 4 rows = 32 CTAs alone; split 8 ways, 256."""
    assert flash_bwd_splits(4, 512, 8, 1) == 8


@pytest.mark.parametrize("args", [(0, 8, 2, 1), (1, -1, 2, 1), (1, 8, 3, 2), (1, 8, 2, 0),
                                  (1, 8, 0, 1)])
def test_splits_refuse_sizes_no_call_has(args):
    with pytest.raises(ValueError, match="flash_bwd_splits"):
        flash_bwd_splits(*args)


@pytest.mark.parametrize("dtype,path", [(torch.float32, "simt"), (torch.bfloat16, "mma"),
                                        (torch.float16, "mma")])
def test_backward_path_follows_the_dtype(dtype, path):
    assert flash_attention_bwd_path(dtype) == path


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.float8_e4m3fn])
def test_backward_path_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="unsupported dtype"):
        flash_attention_bwd_path(dtype)


def _args(dtype=torch.bfloat16, B=2, Sq=5, Skv=7, Hq=4, Hkv=2, hd=16):
    q = torch.zeros((B, Sq, Hq, hd), dtype=dtype)
    k = torch.zeros((B, Skv, Hkv, hd), dtype=dtype)
    lse = torch.zeros((B, Hq, Sq), dtype=torch.float32)
    return {"dout": q.clone(), "q": q, "k": k, "v": k.clone(), "out": q.clone(), "lse": lse}


def _bad(change):
    a = _args()
    a.update(change(a))
    return a


@pytest.fixture
def no_launch(monkeypatch):
    """The wrapper must raise before it builds, sizes or launches anything."""
    def refuse(*_):
        raise AssertionError("reached the kernel")
    monkeypatch.setattr(ops, "_bwd_lib", refuse)
    monkeypatch.setattr(ops, "_sm_count", refuse)
    before = (flash_attention_bwd_cuda.launches, dict(flash_attention_bwd_cuda.launches_by_path))
    yield
    assert (flash_attention_bwd_cuda.launches,
            flash_attention_bwd_cuda.launches_by_path) == before


@pytest.mark.parametrize("args,exc,match", [
    (_args(torch.int32), TypeError, "unsupported dtypes"),
    (_args(torch.float64), TypeError, "unsupported dtypes"),
    (_bad(lambda a: {"k": a["k"].float()}), TypeError, "unsupported dtypes"),
    (_args(hd=48), ValueError, "hd in"),
    (_args(hd=120), ValueError, "hd in"),
    (_args(Hq=3, Hkv=2), ValueError, "does not fit"),
    (_bad(lambda a: {"v": a["v"][:, :3]}), ValueError, "does not fit"),
    (_bad(lambda a: {"lse": torch.zeros((2, 5, 4))}), ValueError, "lse must be"),
    (_bad(lambda a: {"lse": a["lse"].bfloat16()}), ValueError, "lse must be"),
    (_bad(lambda a: {"dout": a["dout"][:, :4]}), ValueError, "do not fit"),
    (_bad(lambda a: {"out": a["out"].half()}), ValueError, "do not fit"),
    (_args(), ValueError, "needs CUDA"),
    (_args(torch.float32), ValueError, "needs CUDA"),
])
def test_backward_wrapper_raises_before_any_launch(no_launch, args, exc, match):
    with pytest.raises(exc, match=match):
        flash_attention_bwd_cuda(args["dout"], args["q"], args["k"], args["v"], args["out"],
                                 args["lse"], True, None, 0)


def test_backward_wrapper_refuses_a_window_below_one(no_launch):
    a = _args()
    with pytest.raises(ValueError, match="window must be"):
        flash_attention_bwd_cuda(a["dout"], a["q"], a["k"], a["v"], a["out"], a["lse"], True,
                                 0, 0)
